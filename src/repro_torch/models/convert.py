"""Carry reference (JAX) DistilBERT weights into the port.

Two sources, neither needing JAX:
  - the reference's param pytree as numpy arrays (nested dicts and
    lists, e.g. ``jax.tree.map(np.asarray, params)``);
  - a flat npz written by ``repro.training.checkpoint.save``, whose keys
    are the tree's '/'-joined paths (read with :func:`load_flat_npz`).

Both flatten to the reference's key paths, which are the port module's
``state_dict`` keys with '/' for '.'; every weight keeps its reference
shape (dense ``[d_in, d_out]``, applied as ``x @ W``), so nothing is
transposed.  A missing or extra key, or a shape that differs, raises —
as ``repro.training.checkpoint.load_into`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.distilbert import DistilBERT


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {'a/0/b': array} (the checkpoint
    key format)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def load_flat_npz(path: str) -> dict[str, np.ndarray]:
    """A flat checkpoint from ``repro.training.checkpoint.save``."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        return {k: z[k] for k in z.files}


def load_state(model: torch.nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Copy flat reference arrays into ``model`` in place; raises on any
    key or shape mismatch."""
    state = model.state_dict()
    want = {k.replace(".", "/"): k for k in state}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={missing[:5]} "
                         f"extra={extra[:5]}")
    bad = [(k, tuple(flat[k].shape), tuple(state[want[k]].shape))
           for k in want if tuple(flat[k].shape) != tuple(state[want[k]].shape)]
    if bad:
        raise ValueError(f"checkpoint shape mismatch (key, saved, model): "
                         f"{bad[:5]}")
    with torch.no_grad():
        for k, name in want.items():
            # np.array copies: a JAX-backed array is read-only
            state[name].copy_(torch.from_numpy(
                np.array(flat[k], dtype=np.float32)))


def distilbert_from_numpy(cfg: dict, tree, *, device="cuda") -> DistilBERT:
    """A port DistilBERT on ``device`` holding the reference weights in
    ``tree`` (a nested param tree or an already-flat checkpoint dict,
    which flattens to itself)."""
    model = DistilBERT(cfg, device=resolve_device(device))
    load_state(model, flatten_tree(tree))
    return model.eval()
