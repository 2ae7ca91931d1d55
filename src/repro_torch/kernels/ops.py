"""Public entry points for the port's kernels.

Dispatch policy (``impl=``), the port of ``repro.kernels.ops``:
  - ``"auto"`` — the production setting: the hand-written CUDA kernel
    for a CUDA tensor, the plain PyTorch version for a CPU tensor.  On a
    CUDA device that is not sm_90 the kernel raises; nothing falls back
    quietly to the plain version.
  - ``"ref"``  — always the plain PyTorch version.
  - ``"cuda"`` — the CUDA kernel, or raise (a CPU tensor raises).

Only ``entropy_stats`` lies on the classify path; the attention and
scan kernels of ``repro.kernels`` come with their slices.
"""
from __future__ import annotations

from repro_torch.kernels import entropy as _ent

IMPLS = ("auto", "ref", "cuda")


def entropy_stats(logits, *, impl: str = "auto"):
    """logits [B,V] -> (entropy, max_prob, argmax).  The controller's
    L(x) hot spot."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        return _ent.entropy_stats_plain(logits)
    if impl == "cuda":
        return _ent.entropy_stats_cuda(logits)
    return _ent.entropy_stats(logits)
