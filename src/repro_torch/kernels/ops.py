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

A DTensor argument (a sharded step, ``launch.sharding``) of any entry
but the paged one (no paged pool is sharded: ``cache_specs`` refuses
one) goes through
``torch.distributed.tensor.experimental.local_map``: the kernel (or the
plain version) runs on each rank's local tensors, which never reach a
kernel as DTensors (``runtime.check_kernel_tensors`` raises on one).
Each entry names the role of every dimension of its tensors (``_ROLES``:
``b`` batch, ``h`` query heads, ``kh`` KV heads), and a mesh dimension
keeps its placement only where the local computation stays exact: a
batch shard, or a head shard that holds whole GQA groups (the query
heads and the KV heads over the same mesh dimension).  Any other
placement, a sequence-sharded KV cache's among them, is replicated
before the call: the rows are all-gathered.  The outputs come back
placed as the query's kept shards.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import entropy as _ent
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd

IMPLS = ("auto", "ref", "cuda")
PAGED_IMPLS = ("auto", "ref", "cuda", "shim")


def _check(impl: str, impls: tuple[str, ...] = IMPLS) -> None:
    if impl not in impls:
        raise ValueError(f"impl must be one of {impls}, got {impl!r}")


# each entry's (roles of its tensor arguments' dims, of its outputs' dims)
_Q3, _KV4 = ("b", "h", None), ("b", "kh", None, None)
_ROLES = {
    "entropy_stats": ((("b", None),), (("b",),) * 3),
    "flash_attention": ((("b", "h", None, None), _KV4, _KV4),
                        (("b", "h", None, None),)),
    "decode_attention": ((_Q3, _KV4, _KV4, ("b", None), ("b",)), (_Q3,)),
    "decode_attention_chunk": ((("b", None, "h", None), _KV4, _KV4,
                                ("b", None), ("b",)),
                               (("b", None, "h", None),)),
    "ssd_scan": ((("b", None, "h", None), ("b", None, "h"), ("h",),
                  ("b", None, None), ("b", None, None)),
                 (("b", None, "h", None),)),
    "ssd_chunked": ((("b", None, "h", None), ("b", None, "h"), ("h",),
                     ("b", None, None), ("b", None, None),
                     ("b", "h", None, None)),
                    (("b", None, "h", None), ("b", "h", None, None))),
}


def local_call(fn, roles, out_roles, *args, **kw):
    """``fn`` on DTensor arguments through ``local_map``: ``roles`` name
    each tensor argument's dims (None for an argument that is not a
    tensor), ``out_roles`` each output's.  A mesh dimension keeps the
    query's (the first argument's) shard of a batch dim, or of a head
    dim when every KV head dim is sharded over it too (whole GQA
    groups).  When the KV heads are replicated over it and each rank's
    query heads fall in one GQA group (G a multiple of the local head
    count: internlm2's 48 / 8 heads on 16 ranks), the query heads stay
    sharded and each rank reads its one KV head.  Anything else is
    replicated (the module docstring says why).  A plain tensor
    argument counts as replicated.  In the backward, an input that a
    kept mesh dim holds whole gets each rank's partial gradient summed
    (a GQA group's KV heads, SSD's B and C, a batch shard's share of a
    weight)."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    args = [a if a is None or isinstance(a, DTensor) else
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False) for a in args]
    kv = [(a, r.index("kh")) for a, r in zip(args, roles) if r and "kh" in r]

    def dim_of(r, role):
        # the dim of r that a mesh dim's role shards; "hq" leaves KV whole
        names = {"b": ("b",), "h": ("h", "kh"), "hq": ("h",)}[role]
        return next((d for d, x in enumerate(r) if x in names), None)

    kept = []          # each mesh dim's role: "b", "h", "hq" or None
    for i in range(mesh.ndim):
        p = args[0].placements[i]
        role = (roles[0][p.dim % args[0].dim()] if isinstance(p, Shard)
                else None)
        if role == "h" and any(a.placements[i] != Shard(d) for a, d in kv):
            H, n = args[0].shape[p.dim % args[0].dim()], mesh.size(i)
            G = H // kv[0][0].shape[kv[0][1]]
            one_group = (H % n == 0 and G % (H // n) == 0 and "hq" not in
                         kept and all(a.placements[i].is_replicate()
                                      for a, _ in kv))
            role = "hq" if one_group else None
        kept.append(role)

    def place(r):
        if r is None:
            return None
        return tuple(Replicate() if role is None or dim_of(r, role) is None
                     else Shard(dim_of(r, role)) for role in kept)

    def grad_place(r):
        # a mesh dim that splits the work (a kept role) and holds this
        # input whole gives each rank a partial sum of its gradient (the
        # rows or heads of its own shard): summed, not replicated
        if r is None:
            return None
        return tuple(Partial() if role is not None and p.is_replicate()
                     else p for role, p in zip(kept, place(r)))

    local = fn
    if "hq" in kept:
        i = kept.index("hq")
        h_local = args[0].shape[roles[0].index("h")] // mesh.size(i)
        G = args[0].shape[roles[0].index("h")] // kv[0][0].shape[kv[0][1]]
        j = mesh.get_local_rank(i) * h_local // G     # this rank's KV head

        def local(*a, **k):
            a = [x.narrow(r.index("kh"), j, 1) if r and "kh" in r else x
                 for x, r in zip(a, roles)]
            return fn(*a, **k)

    return local_map(local, out_placements=tuple(list(place(r))
                                                 for r in out_roles),
                     in_placements=tuple(place(r) for r in roles),
                     in_grad_placements=tuple(grad_place(r) for r in roles),
                     device_mesh=mesh, redistribute_inputs=True)(*args, **kw)


def _dtensor_call(fn, *args, **kw):
    """An entry of this module on DTensor arguments (``local_call`` with
    the entry's ``_ROLES``)."""
    return local_call(fn, *_ROLES[fn.__name__], *args, **kw)


def _sharded(*ts) -> bool:
    return any(isinstance(t, DTensor) for t in ts)


def entropy_stats(logits, *, impl: str = "auto"):
    """logits [B,V] -> (entropy, max_prob, argmax).  The controller's
    L(x) hot spot."""
    _check(impl)
    if _sharded(logits):
        return _dtensor_call(entropy_stats, logits, impl=impl)
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
    if _sharded(q, k, v):
        return _dtensor_call(flash_attention, q, k, v, impl=impl, **kw)
    if impl == "ref":
        return _fa.flash_attention_plain(q, k, v, **kw)
    if impl == "cuda":
        return _fa.flash_attention_cuda(q, k, v, **kw)
    return _fa.flash_attention(q, k, v, **kw)


def decode_attention(q, k, v, kv_pos, cur_pos, *, window=0,
                     impl: str = "auto"):
    """q [B,H,hd]; k/v [B,K,S,hd]; kv_pos [B,S]; cur_pos [B] -> [B,H,hd]."""
    _check(impl)
    if _sharded(q, k, v, kv_pos, cur_pos):
        return _dtensor_call(decode_attention, q, k, v, kv_pos, cur_pos,
                             window=window, impl=impl)
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
    if _sharded(q, k, v, kv_pos, start):
        return _dtensor_call(decode_attention_chunk, q, k, v, kv_pos, start,
                             window=window, impl=impl)
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
    if _sharded(x, dt, A, Bm, Cm):
        return _dtensor_call(ssd_scan, x, dt, A, Bm, Cm, chunk=chunk,
                             impl=impl)
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
    if _sharded(x, dt, A, Bm, Cm, h0):
        return _dtensor_call(ssd_chunked, x, dt, A, Bm, Cm, h0, chunk=chunk,
                             impl=impl)
    if impl == "ref":
        return _ssd.ssd_chunked_plain(x, dt, A, Bm, Cm, h0, chunk)
    if impl == "cuda":
        return _ssd.ssd_chunked_cuda(x, dt, A, Bm, Cm, h0)
    return _ssd.ssd_chunked(x, dt, A, Bm, Cm, h0, chunk)
