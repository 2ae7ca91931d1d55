"""Flat-npz checkpoints in the reference's layout, ported from
``repro.training.checkpoint``: a file written by either package loads
into the other.

A tree of dicts, lists, tuples, NamedTuples (``AdamWState``), tensors,
numpy arrays and Python numbers flattens to '/'-joined key paths, as the
reference's pytree does.  An ``LM`` in the tree flattens to the
reference's parameter layout (``convert.lm_to_flat``: a homogeneous
stack's layers stacked, a mixed stack's per layer), and so does any dict
in the tree keyed by that LM's parameter names (the AdamW moments over
it): ``{"params": model, "opt": opt_state}`` writes the keys
``params/...``, ``opt/m/...``, ``opt/v/...`` and ``opt/count`` of the
reference's ``{"params": params, "opt": state}``.  bf16 is written as
f32 (numpy has no bf16) and restored to the template's dtype; a Python
int (the step count) as int32.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.models import convert
from repro_torch.models.transformer import LM


def _models(tree, out=None) -> list:
    """Every LM in ``tree``, as (its parameter names, its config)."""
    out = [] if out is None else out
    if isinstance(tree, LM):
        out.append((frozenset(tree.state_dict()), tree.cfg))
    elif isinstance(tree, dict):
        for v in tree.values():
            _models(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _models(v, out)
    return out


def _layout_of(node, models):
    """The config whose parameter names key the dict ``node``, or None."""
    if isinstance(node, dict) and node:
        keys = set(node)
        return next((cfg for names, cfg in models if keys == names), None)
    return None


def _flatten(tree, models, leaf, prefix=""):
    """{'/'-joined path: leaf(x)} over the tree, LMs and dicts keyed by
    their parameter names in the reference's layout."""
    if isinstance(tree, LM):
        named = {k: leaf(t) for k, t in tree.state_dict().items()}
        return {prefix + k: v for k, v in convert.lm_flat(tree.cfg,
                                                          named).items()}
    cfg = _layout_of(tree, models)
    if cfg is not None:
        named = {k: leaf(t) for k, t in tree.items()}
        return {prefix + k: v for k, v in convert.lm_flat(cfg, named).items()}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, models, leaf, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):                    # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), models, leaf,
                                f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, models, leaf, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = leaf(tree)
    return out


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, int) and not isinstance(x, bool):
        return np.asarray(x, np.int32)
    return np.asarray(x)


def _shape(x) -> tuple:
    """A leaf's shape, through a meta tensor so that stacking is free."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("meta")
    return torch.empty(np.shape(x), device="meta")


def save(path: str, tree, *, metadata: dict | None = None) -> None:
    """Write ``tree`` to ``path`` (npz) and ``metadata``, when given, to
    ``path + ".meta.json"``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree, _models(tree), _to_numpy))
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2)


def _sub(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _rebuild(template, flat, models, prefix=""):
    if isinstance(template, LM):
        return convert.load_lm(template, _sub(flat, prefix))
    cfg = _layout_of(template, models)
    if cfg is not None:
        per_layer = convert.lm_unflat(cfg, _sub(flat, prefix))
        with torch.no_grad():
            for k, a in per_layer.items():
                template[k.replace("/", ".")].copy_(torch.from_numpy(
                    np.asarray(a)))
        return template
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, models, f"{prefix}{k}/")
                for k, v in template.items()}
    if hasattr(template, "_fields"):                  # NamedTuple
        return type(template)(**{
            k: _rebuild(getattr(template, k), flat, models, f"{prefix}{k}/")
            for k in template._fields})
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, flat, models, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    a = flat[prefix[:-1]]
    if isinstance(template, torch.Tensor):
        with torch.no_grad():
            return template.copy_(torch.from_numpy(np.asarray(a)))
    if isinstance(template, (int, float)):
        return type(template)(a)
    return np.asarray(a, dtype=np.asarray(template).dtype)


def load_into(path: str, template):
    """Restore a checkpoint into a tree of the structure it was saved
    from: tensors, LMs and their AdamW moments are overwritten in place
    (each in its own dtype and device), numbers and numpy arrays come
    back new; returns the rebuilt tree.  A missing or extra key, or a
    shape that differs, raises ``ValueError``."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    models = _models(template)
    want = _flatten(template, models, _shape)
    if set(want) != set(flat):
        missing = set(want) - set(flat)
        extra = set(flat) - set(want)
        raise ValueError(f"checkpoint mismatch: missing={sorted(missing)[:5]}"
                         f" extra={sorted(extra)[:5]}")
    bad = [(k, flat[k].shape, tuple(want[k].shape)) for k in sorted(want)
           if flat[k].shape != tuple(want[k].shape)]
    if bad:
        raise ValueError(f"checkpoint shape mismatch (key, saved, template): "
                         f"{bad[:5]}")
    return _rebuild(template, flat, models)
