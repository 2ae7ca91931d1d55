"""Seeded weights, made on the device by the benchmark and handed to both
sides: the program gets them as its parameters, the reference makes them
again from the same seed after the program is gone.

The layout is the port's documented one (``models/nn.py``): dense
matrices ``[d_in, d_out]`` applied as ``x @ W``, experts stacked
``[E, d_in, d_out]``, the router ``[d, E]`` in float32, LayerNorm
``scale``/``bias`` and RMSNorm stored as an offset from 1 (``x * (1 +
scale)``), both float32.  Matrices are drawn in the served type from one
``torch.Generator`` on the card in one call, then scaled by
``1/sqrt(fan_in)`` (the embedding by ``1/sqrt(d)``); the router in a
second call; every norm scale and bias in a third, ``NORM_SD`` apart
from the identity (scale ``1 + NORM_SD * N(0, 1)``, RMSNorm's offset,
biases ``NORM_SD * N(0, 1)``), so that a program that drops or misapplies
one reads wrong.
"""
from __future__ import annotations

import math

import torch

NORM_SD = 0.2
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def dims(m: dict) -> dict:
    """Sizes of a ``model`` block (the port's ``ModelConfig`` fields)."""
    d, H = m["d_model"], m["n_heads"]
    return dict(d=d, H=H, K=m["n_kv_heads"], hd=m.get("head_dim") or d // H,
                L=m["n_layers"], V=m["vocab"], f=m.get("d_ff", 0),
                E=m.get("n_experts", 0), k=m.get("top_k", 0),
                fe=m.get("d_ff_expert", 0), tie=m.get("tie_embeddings", True),
                norm=m.get("norm", "rmsnorm"), bias=m.get("qkv_bias", False),
                rope_pct=m.get("rope_pct", 1.0),
                theta=m.get("rope_theta", 10000.0),
                dtype=DTYPES[m.get("dtype", "bfloat16")])


def specs(m: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in drawing order; kind is
    ``"matrix"``, ``"embed"``, ``"router"``, ``"scale"`` (drawn around 1)
    or ``"shift"`` (drawn around 0)."""
    z = dims(m)
    d, H, K, hd = z["d"], z["H"], z["K"], z["hd"]

    def norm(prefix):
        if z["norm"] == "layernorm":
            return [(f"{prefix}.scale", (d,), "scale"),
                    (f"{prefix}.bias", (d,), "shift")]
        return [(f"{prefix}.scale", (d,), "shift")]

    out = [("emb", (z["V"], d), "embed")]
    out += norm("final_norm")
    if not z["tie"]:
        out.append(("unemb", (d, z["V"]), "matrix"))
    for i in range(z["L"]):
        p = f"layers.{i}"
        out += norm(f"{p}.norm1")
        out += [(f"{p}.mix.wq", (d, H * hd), "matrix"),
                (f"{p}.mix.wk", (d, K * hd), "matrix"),
                (f"{p}.mix.wv", (d, K * hd), "matrix"),
                (f"{p}.mix.wo", (H * hd, d), "matrix")]
        if z["bias"]:
            out += [(f"{p}.mix.b{n}", (w,), "shift") for n, w in
                    (("q", H * hd), ("k", K * hd), ("v", K * hd), ("o", d))]
        out += norm(f"{p}.norm2")
        if z["E"]:
            E, fe = z["E"], z["fe"]
            out += [(f"{p}.moe.router", (d, E), "router"),
                    (f"{p}.moe.w_gate", (E, d, fe), "matrix"),
                    (f"{p}.moe.w_up", (E, d, fe), "matrix"),
                    (f"{p}.moe.w_down", (E, fe, d), "matrix")]
        else:
            out += [(f"{p}.mlp.w_gate", (d, z["f"]), "matrix"),
                    (f"{p}.mlp.w_up", (d, z["f"]), "matrix"),
                    (f"{p}.mlp.w_down", (z["f"], d), "matrix")]
    return out


@torch.no_grad()
def make(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter by name, from ``seed``.  The matrices are views of
    one buffer in the served type; the same seed gives the same bits."""
    z = dims(m)
    sp = specs(m)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    n_mat = sum(math.prod(s) for _, s, k in sp if k in ("matrix", "embed"))
    n_rt = sum(math.prod(s) for _, s, k in sp if k == "router")
    n_nm = sum(math.prod(s) for _, s, k in sp if k in ("scale", "shift"))
    flat = torch.randn(n_mat, dtype=z["dtype"], device=device, generator=gen)
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
