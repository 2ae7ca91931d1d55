"""Public entry points for the port's kernels.

Dispatch policy (``impl=``), the port of ``repro.kernels.ops``:
  - ``"auto"`` — the production setting: the hand-written CUDA kernel
    for a CUDA tensor, the plain PyTorch version for a CPU tensor.  On a
    CUDA device that is not sm_90 the kernel raises; nothing falls back
    quietly to the plain version.
  - ``"ref"``  — always the plain PyTorch version.
  - ``"cuda"`` — the CUDA kernel, or raise (a CPU tensor raises).
  - ``"shim"``  — ``paged_decode_attention`` only: the table gather then
    the contiguous CUDA kernel, the paged kernel's parity oracle (a CPU
    tensor raises), as the reference's ``_PAGED_IMPLS``.

``entropy_stats`` carries the classify path; ``flash_attention`` (every
prefill) and ``decode_attention`` (every decode step) carry the
generate path, ``paged_decode_attention`` every decode step over
the paged pool, and ``decode_attention_chunk`` (the port's own entry on
the flash-decode body) every speculative verify chunk; ``ssd_scan``
and ``ssd_chunked`` every prefill of an SSD (Mamba-2) stack.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import entropy as _ent
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd

IMPLS = ("auto", "ref", "cuda")
PAGED_IMPLS = ("auto", "ref", "cuda", "shim")


def _check(impl: str, impls: tuple[str, ...] = IMPLS) -> None:
    if impl not in impls:
        raise ValueError(f"impl must be one of {impls}, got {impl!r}")


def entropy_stats(logits, *, impl: str = "auto"):
    """logits [B,V] -> (entropy, max_prob, argmax).  The controller's
    L(x) hot spot."""
    _check(impl)
    if impl == "ref":
        return _ent.entropy_stats_plain(logits)
    if impl == "cuda":
        return _ent.entropy_stats_cuda(logits)
    return _ent.entropy_stats(logits)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    impl: str = "auto"):
    """q [B,H,Sq,hd]; k/v [B,K,Skv,hd] (GQA: H = K*G) -> [B,H,Sq,hd]."""
    _check(impl)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if impl == "ref":
        return _fa.flash_attention_plain(q, k, v, **kw)
    if impl == "cuda":
        return _fa.flash_attention_cuda(q, k, v, **kw)
    return _fa.flash_attention(q, k, v, **kw)


def decode_attention(q, k, v, kv_pos, cur_pos, *, window=0,
                     impl: str = "auto"):
    """q [B,H,hd]; k/v [B,K,S,hd]; kv_pos [B,S]; cur_pos [B] -> [B,H,hd]."""
    _check(impl)
    if impl == "ref":
        return _da.decode_attention_plain(q, k, v, kv_pos, cur_pos,
                                          window=window)
    if impl == "cuda":
        return _da.decode_attention_cuda(q, k, v, kv_pos, cur_pos,
                                         window=window)
    return _da.decode_attention(q, k, v, kv_pos, cur_pos, window=window)


def decode_attention_chunk(q, k, v, kv_pos, start, *, window=0,
                           impl: str = "auto"):
    """q [B,n,H,hd]; k/v [B,K,S,hd]; kv_pos [B,S]; start [B] ->
    [B,n,H,hd]: n query rows per slot at positions start .. start+n-1,
    each attending as ``decode_attention`` at its own position."""
    _check(impl)
    if impl == "ref":
        return _da.decode_attention_chunk_plain(q, k, v, kv_pos, start,
                                                window=window)
    if impl == "cuda":
        return _da.decode_attention_chunk_cuda(q, k, v, kv_pos, start,
                                               window=window)
    return _da.decode_attention_chunk(q, k, v, kv_pos, start, window=window)


def paged_decode_attention(q, k_pool, v_pool, block_table, kv_pos, cur_pos,
                           *, window=0, impl: str = "auto"):
    """q [B,H,hd]; k/v pool [NB,bs,K,hd]; block_table [B,MB];
    kv_pos [B,MB*bs]; cur_pos [B] -> [B,H,hd].  Validity rides on
    kv_pos alone: unmapped table entries point at the trash block, whose
    rows are never valid."""
    _check(impl, PAGED_IMPLS)
    args = (q, k_pool, v_pool, block_table, kv_pos, cur_pos)
    if impl == "ref":
        return _da.paged_decode_attention_plain(*args, window=window)
    if impl == "cuda":
        return _da.paged_decode_attention_cuda(*args, window=window)
    if impl == "shim":
        return _da.paged_decode_attention_shim(*args, window=window)
    return _da.paged_decode_attention(*args, window=window)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=128, impl: str = "auto"):
    """x [B,S,H,hd], dt [B,S,H], A [H], Bm/Cm [B,S,N] -> y [B,S,H,hd]
    from a zero state: the Mamba-2 SSD chunked scan.  ``chunk`` keeps
    the reference's signature and changes nothing: the plain version is
    per token and the kernel takes its own chunk length."""
    _check(impl)
    if impl == "ref":
        return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm)
    if impl == "cuda":
        return _ssd.ssd_scan_cuda(x, dt, A, Bm, Cm)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm)


def ssd_chunked(x, dt, A, Bm, Cm, h0, *, chunk: int, impl: str = "auto"):
    """The SSD scan from the state h0 [B,H,hd,N] f32 -> (y, h_last):
    what an SSD layer's prefill runs.  ``chunk`` is the plain version's
    chunk length."""
    _check(impl)
    if impl == "ref":
        return _ssd.ssd_chunked_plain(x, dt, A, Bm, Cm, h0, chunk)
    if impl == "cuda":
        return _ssd.ssd_chunked_cuda(x, dt, A, Bm, Cm, h0)
    return _ssd.ssd_chunked(x, dt, A, Bm, Cm, h0, chunk)
