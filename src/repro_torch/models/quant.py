"""Int8 weight quantisation, ported from ``repro.models.quant``.

Per-output-channel symmetric int8: w ~ q * scale, q in [-127, 127],
the scale the largest |w| over every leading axis / 127.  The
functions work on the reference's flat layout (``convert.lm_to_flat``),
where a homogeneous stack's leaf is ``[L, d_in, d_out]``: the scale of
an output channel then spans all L layers and a leaf is judged eligible
(>= 1 Mi elements, floating, at least 2-D) stacked, as the reference
judges it; per layer, other leaves would be chosen and other bytes
written.  ``torch.round`` rounds half to even, as ``jnp.round`` does,
so ``q`` and ``scale`` are the reference's byte for byte.
``load_dequantized`` puts a dequantised tree back into an ``LM``, and
``quantize_specs`` mirrors a sharding spec dict
(``launch.sharding.param_specs``) onto the quantised structure.
"""
from __future__ import annotations

import torch

from repro_torch.models import convert
from repro_torch.models.transformer import LM

MIN_QUANT_SIZE = 1 << 20        # only quantise leaves >= 1 Mi elements


def _is_qdict(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def quantize(w: torch.Tensor) -> dict:
    """[..., d_out] -> {'q': int8, 'scale': f32 per output channel}."""
    wf = w.float()
    a = wf.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    scale = torch.clamp(a, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize(d: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return d["q"].to(dtype) * d["scale"].to(dtype)


def _eligible(leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.numel() >= MIN_QUANT_SIZE
            and leaf.is_floating_point() and leaf.dim() >= 2)


def quantize_tree(params: dict) -> dict:
    """Quantise every large float matrix leaf of a flat dict; others
    pass through."""
    return {k: quantize(v) if _eligible(v) else v for k, v in params.items()}


def dequantize_tree(qparams: dict, dtype=torch.bfloat16) -> dict:
    return {k: dequantize(v, dtype) if _is_qdict(v) else v
            for k, v in qparams.items()}


def quantize_specs(spec_tree: dict, params_abs: dict) -> dict:
    """Mirror a spec dict onto ``quantize_tree(params_abs)``'s structure:
    'q' keeps the original spec, 'scale' keeps only the last-dim
    component (it broadcasts along the reduced axes)."""
    out = {}
    for k, spec in spec_tree.items():
        leaf = params_abs[k]
        if not _eligible(leaf):
            out[k] = spec
            continue
        last = (tuple(spec) + (None,) * leaf.dim())[leaf.dim() - 1]
        out[k] = {"q": spec, "scale": (None,) * (leaf.dim() - 1) + (last,)}
    return out


def quantization_error(params: dict) -> dict:
    """Max relative error per quantised leaf (diagnostics/tests)."""
    out = {}
    for k, leaf in params.items():
        if _eligible(leaf):
            back = dequantize(quantize(leaf), torch.float32)
            err = (back - leaf.float()).abs().max()
            out[k] = float(err / (leaf.float().abs().max() + 1e-9))
    return out


def load_dequantized(model: LM, qparams: dict, dtype=torch.bfloat16) -> LM:
    """Load ``qparams`` (``quantize_tree`` of the model's flat layout)
    into ``model`` in place, each quantised leaf dequantised in
    ``dtype`` first (then cast to the parameter's own dtype)."""
    return convert.load_lm(model, dequantize_tree(qparams, dtype))
