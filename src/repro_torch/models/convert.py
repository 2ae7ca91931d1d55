"""Carry reference (JAX) DistilBERT, LM (every family) and ResNet-18
weights into the port.

Two sources, neither needing JAX:
  - the reference's param pytree as numpy arrays (nested dicts and
    lists, e.g. ``jax.tree.map(np.asarray, params)``);
  - a flat npz written by ``repro.training.checkpoint.save``, whose keys
    are the tree's '/'-joined paths (read with :func:`load_flat_npz`).

Both flatten to the reference's key paths, which are the port module's
``state_dict`` keys with '/' for '.'; every weight keeps its reference
shape (dense ``[d_in, d_out]``, applied as ``x @ W``), so nothing is
transposed but ResNet-18's convolutions (HWIO in the reference, OIHW in
the port).  A missing or extra key, or a shape that differs, raises —
as ``repro.training.checkpoint.load_into`` does.

The other way, ``lm_to_flat`` gives an LM's weights in the reference's
flat layout (layers stacked as the reference stacks them), which the
port's checkpoints and int8 quantisation use, and ``load_lm`` loads
such a dict, of numpy arrays or tensors, into an LM in place.  One
leaf is reshaped on the way, both ways: MLA's up-projections ``w_uk``
/ ``w_uv``, [r, H, n] in the reference and [r, H*n] in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.distilbert import DistilBERT
from repro_torch.models.resnet import ResNet18
from repro_torch.models.transformer import LM

# MLA's up-projections: [r, H*n] in the port, [r, H, n] in the reference
_HEADED = ("w_uk", "w_uv")


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
    # MLA's up-projections in the reference's [r, H, n] become the
    # port's [r, H*n]
    flat = {k: a.reshape(*a.shape[:-2], -1) if k.endswith(_HEADED)
            and k in want and a.ndim == state[want[k]].dim() + 1 else a
            for k, a in flat.items()}
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
            # np.array copies (a JAX-backed array is read-only) and widens
            # bf16 exactly; copy_ casts to the parameter's own dtype
            a = flat[k]
            state[name].copy_(a if isinstance(a, torch.Tensor) else
                              torch.from_numpy(np.array(a, dtype=np.float32)))


def distilbert_from_numpy(cfg: dict, tree, *, device="cuda") -> DistilBERT:
    """A port DistilBERT on ``device`` holding the reference weights in
    ``tree`` (a nested param tree or an already-flat checkpoint dict,
    which flattens to itself)."""
    model = DistilBERT(cfg, device=resolve_device(device))
    load_state(model, flatten_tree(tree))
    return model.eval()


def unstack_layers(flat: dict[str, np.ndarray], n_layers: int, *,
                   prefix: str = "layers") -> dict[str, np.ndarray]:
    """The reference stacks a homogeneous stack's layer leaves
    (``layers/mix/wq`` [L, d, H*hd], an MoE layer's experts
    ``layers/moe/w_gate`` [L, E, D, F], MLA's ``layers/mix/w_uk`` [L, r,
    H, nope]), and an encoder-decoder's ``encoder/layers/*`` and
    ``xattn/*``; the port keeps one module per layer (``layers/0/mix/wq``
    [d, H*hd]).  Split every stacked leaf under ``prefix`` along its
    first axis; raise when that axis is not ``n_layers`` long.  Keys
    already per layer (a mixed stack's ``layers`` is a list in the
    reference, ``layers/0/...``) and keys elsewhere pass through."""
    out = {}
    head = prefix.split("/")
    for key, a in flat.items():
        parts = key.split("/")
        rest = parts[len(head):]
        if parts[:len(head)] != head or not rest or rest[0].isdigit():
            out[key] = a
            continue
        if a.ndim == 0 or a.shape[0] != n_layers:
            raise ValueError(f"stacked leaf {key!r} has shape "
                             f"{tuple(a.shape)}, expected [{n_layers}, ...]")
        for i in range(n_layers):
            out["/".join([*head, str(i), *rest])] = a[i]
    return out


def stack_layers(flat: dict, n_layers: int, *,
                 prefix: str = "layers") -> dict:
    """The inverse of :func:`unstack_layers`, on tensors or numpy
    arrays: every ``prefix/i/rest`` (i < ``n_layers``) stacked along a
    new first axis into ``prefix/rest``; keys elsewhere pass through.
    Raises when a layer lacks a leaf the others have."""
    head = prefix.split("/")
    out, groups = {}, {}
    for key, t in flat.items():
        parts = key.split("/")
        rest = parts[len(head):]
        if parts[:len(head)] != head or not rest or not rest[0].isdigit():
            out[key] = t
            continue
        groups.setdefault("/".join(rest[1:]), {})[int(rest[0])] = t
    for rest, by_layer in groups.items():
        if sorted(by_layer) != list(range(n_layers)):
            raise ValueError(f"{prefix}/*/{rest} is held by layers "
                             f"{sorted(by_layer)}, expected 0..{n_layers - 1}")
        leaves = [by_layer[i] for i in range(n_layers)]
        out["/".join([*head, rest])] = (
            torch.stack(leaves) if isinstance(leaves[0], torch.Tensor)
            else np.stack(leaves))
    return out


def _mla_heads(cfg: ModelConfig, flat: dict, split: bool) -> dict:
    """Per-layer keys: every MLA up-projection split into the reference's
    heads (``split``), or merged back into the port's matrix."""
    def shape(t):
        if split:
            return t.reshape(*t.shape[:-1], cfg.n_heads, -1)
        return t.reshape(*t.shape[:-2], -1)
    return {k: shape(t) if k.startswith("layers/")
            and k.endswith(tuple("/mix/" + n for n in _HEADED)) else t
            for k, t in flat.items()}


def lm_flat(cfg: ModelConfig, named) -> dict:
    """A dict keyed by an LM's parameter names (``state_dict``,
    ``named_parameters``, or AdamW moments over them) in the reference's
    flat layout: '/' for '.', MLA's up-projections split into heads, a
    homogeneous stack's layers stacked, a mixed stack's kept per layer
    (the reference's list), an encoder-decoder's ``encoder/layers`` and
    ``xattn`` stacked."""
    flat = _mla_heads(cfg, {k.replace(".", "/"): t
                            for k, t in named.items()}, split=True)
    if cfg.homogeneous:
        flat = stack_layers(flat, cfg.n_layers)
    if cfg.family == "encdec":
        flat = stack_layers(flat, cfg.n_enc_layers, prefix="encoder/layers")
        flat = stack_layers(flat, cfg.n_layers, prefix="xattn")
    return flat


def lm_unflat(cfg: ModelConfig, flat: dict) -> dict:
    """The inverse of :func:`lm_flat`: the reference's flat layout keyed
    per layer, with '/' (the port's names with '/' for '.')."""
    flat = unstack_layers(flat, cfg.n_layers)
    if cfg.family == "encdec":
        flat = unstack_layers(flat, cfg.n_enc_layers, prefix="encoder/layers")
        flat = unstack_layers(flat, cfg.n_layers, prefix="xattn")
    return _mla_heads(cfg, flat, split=False)


def lm_to_flat(model: LM) -> dict[str, torch.Tensor]:
    """The model's weights in the reference's flat layout (detached
    copies where layers are stacked, on the model's device, in its
    dtypes)."""
    return lm_flat(model.cfg, {k: t.detach()
                               for k, t in model.state_dict().items()})


def load_lm(model: LM, flat: dict) -> LM:
    """Copy a flat dict in the reference's layout (numpy arrays or
    tensors) into ``model`` in place; raises on a missing or extra key
    or a shape mismatch, as :func:`load_state` does."""
    load_state(model, lm_unflat(model.cfg, flat))
    return model


def lm_from_numpy(cfg: ModelConfig, tree, *, device="cuda") -> LM:
    """A port LM on ``device`` holding the weights of the reference's
    ``init_lm`` tree (numpy leaves, e.g. ``jax.tree.map(np.asarray,
    params)``, or an already-flat dict), whatever the family: a
    homogeneous stack's stacked leaves, a mixed stack's list of layers,
    an encoder-decoder's stacked encoder and cross-attention.  Raises on
    a missing or extra key or a shape mismatch, as :func:`load_state`
    does."""
    model = LM(cfg, device=resolve_device(device))
    return load_lm(model, flatten_tree(tree)).eval()


def resnet_from_numpy(tree, *, device="cuda") -> ResNet18:
    """A port ResNet-18 on ``device`` holding the weights of the
    reference's ``resnet.init`` tree (numpy leaves, or an already-flat
    dict), its class count read from ``fc_b``.  Every 4-D leaf (a
    convolution) goes HWIO -> OIHW.  Raises on a missing or extra key or
    a shape mismatch, as :func:`load_state` does."""
    flat = {k: np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a
            for k, a in flatten_tree(tree).items()}
    n_classes = flat["fc_b"].shape[0] if "fc_b" in flat else 1000
    model = ResNet18(n_classes, device=resolve_device(device))
    load_state(model, flat)
    return model.eval()
