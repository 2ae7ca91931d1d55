"""Seeded weights, made on the device by the benchmark and handed to both
sides: the program gets them as its parameters, the reference makes them
again from the same seed after the program is gone.

The names, shapes and kinds are the configuration's reference module's
``specs`` (``perfbench/lib/describe.py``), in the port's parameter
layout; the drawing is by kind, whatever the layout.  Matrices
(``"matrix"``, ``"embed"``; ``[..., d_in, d_out]``) are drawn in the
served type from one ``torch.Generator`` on the card in one call, then
scaled by ``1/sqrt(d_in)`` (the embedding ``[V, d]`` by ``1/sqrt(d)``);
the routers (``"router"``, float32) in a second call, scaled by
``1/sqrt(d_in)``; every norm scale and bias in a third, float32,
``NORM_SD`` apart from the identity (``"scale"``: ``1 + NORM_SD * N(0,
1)``; ``"shift"``, a bias or RMSNorm's offset from 1: ``NORM_SD * N(0,
1)``), so that a program that drops or misapplies one reads wrong.
"""
from __future__ import annotations

import math

import torch

NORM_SD = 0.2
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
KINDS = ("matrix", "embed", "router", "scale", "shift")


@torch.no_grad()
def make(ref, m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter of ``ref.specs(m)`` by name, from ``seed``, the
    matrices in ``ref.dims(m)["dtype"]``.  The matrices are views of one
    buffer in the served type; the same seed gives the same bits."""
    sp = ref.specs(m)
    unknown = {k for _, _, k in sp} - set(KINDS)
    if unknown:
        raise ValueError(f"parameter kinds {sorted(unknown)} are none of {KINDS}")
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    n_mat = sum(math.prod(s) for _, s, k in sp if k in ("matrix", "embed"))
    n_rt = sum(math.prod(s) for _, s, k in sp if k == "router")
    n_nm = sum(math.prod(s) for _, s, k in sp if k in ("scale", "shift"))
    flat = torch.randn(n_mat, dtype=ref.dims(m)["dtype"], device=device,
                       generator=gen)
    rt = (torch.randn(n_rt, dtype=torch.float32, device=device, generator=gen)
          if n_rt else None)
    nm = torch.randn(n_nm, dtype=torch.float32, device=device,
                     generator=gen).mul_(NORM_SD)
    out, i, j, k_nm = {}, 0, 0, 0
    for name, shape, kind in sp:
        n = math.prod(shape)
        if kind in ("matrix", "embed"):
            w = flat[i:i + n].view(shape)
            i += n
            w.mul_(1.0 / math.sqrt(shape[-1] if kind == "embed" else shape[-2]))
        elif kind == "router":
            w = rt[j:j + n].view(shape)
            j += n
            w.mul_(1.0 / math.sqrt(shape[0]))
        else:
            w = nm[k_nm:k_nm + n].view(shape)
            k_nm += n
            if kind == "scale":
                w.add_(1.0)
        out[name] = w
    return out


def install(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Make ``weights`` the model's parameters (no copy).  Every name,
    shape and dtype has to match the model's own."""
    own = dict(model.named_parameters())
    if set(own) != set(weights):
        raise ValueError(f"parameter names differ: model only "
                         f"{sorted(set(own) - set(weights))[:5]}, benchmark "
                         f"only {sorted(set(weights) - set(own))[:5]}")
    for name, p in own.items():
        w = weights[name]
        if tuple(p.shape) != tuple(w.shape) or p.dtype != w.dtype:
            raise ValueError(f"{name}: model {tuple(p.shape)} {p.dtype}, "
                             f"benchmark {tuple(w.shape)} {w.dtype}")
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = torch.nn.Parameter(w, requires_grad=False)
