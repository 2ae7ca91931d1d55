"""The control: the reference put in the program's place at the next
precision below the configuration's bfloat16, computed in float8 (e4m3)
as an fp8 product on the H100 computes: every weight matrix scaled per
output channel (the embedding per row), every input of a product with a
weight scaled per token, both rounded to e4m3, products summed in
float32; the router left in float32 as the configuration states it,
attention's own products in float32.  For each served request it reads,
at every position of the same prompt and served tokens, the token the
control would emit (its argmax) and that token's gap under the float32
reference: the number a program computing at this precision would show.
A limit has to fail it."""
from __future__ import annotations

import torch

from perfbench.lib import bench
from perfbench.lib import weights as wts

E4M3_MAX = 448.0


def fp8(w: torch.Tensor, dim: int) -> torch.Tensor:
    """w rounded to float8 e4m3 with one scale per slice along ``dim``
    (absmax to the format's largest), widened back to float32."""
    w = w.float()
    s = w.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (w / s).to(torch.float8_e4m3fn).float() * s


@torch.no_grad()
def control_readings(ref, m: dict, seed: int, served, device) -> dict:
    """The control's readings over ``served`` by the configuration's
    reference module ``ref``, against ``ref``'s float32 logits."""
    z = ref.dims(m)
    w = wts.make(ref, m, seed, device)
    kinds = {n: k for n, _, k in ref.specs(m)}
    full = lambda name: w[name].float()

    def low(name):
        k = kinds[name]
        if k == "embed":
            return fp8(w[name], -1)
        if k == "matrix":
            return fp8(w[name], -2)
        return w[name].float()

    all_gaps = []
    for spec, plen, gen in served:
        seq, at = bench.sequence(spec, plen, gen, device)
        exact = ref.logits(z, full, seq, at)
        ctl = ref.logits(z, low, seq, at, act=lambda x: fp8(x, -1))
        all_gaps.append(bench.gaps(exact, ctl.argmax(-1)))
    return bench.summarize(all_gaps)
