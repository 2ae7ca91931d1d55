"""The Hopper design of the entropy kernel, held on the CPU.

The CUDA kernel (``csrc/entropy.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain version.  Here the choice
of schedule (:func:`entropy.entropy_schedule`, pure Python) is pinned,
and each schedule is emulated in plain PyTorch f32 in the kernel's
partition and merge order, on inputs made from numpy seeds:

  - packed rows: one thread per row, loads of ``vector`` elements in
    column order, each folded with one rescale;
  - a warp per row and a row split across blocks: the row as a scalar
    head up to its first 16-byte aligned element, aligned vectors of 16
    bytes and a scalar tail; slice k of S owns vectors [n k / S,
    n (k+1) / S), slice 0 the head and the last slice the tail; thread
    t folds head element t, then rounds of UNROLL vectors (t, t + T, ...)
    with one rescale a round, then tail element t; lanes merge as the
    kernel's warp reduction (their maximum, one rescale a lane, sums as
    a tree, the least index among the lanes at the maximum), warps the
    same way, and the slices by rank: the last block's lane l folds
    slices l, l + 32, ... with the pairwise merge, then one warp
    reduction;

against ``repro.kernels.ref.entropy_stats`` and the Pallas kernel in
interpret mode (``repro.kernels.entropy.entropy_stats``), within
``chip_smoke.py``'s ``F32_TOL`` = 1e-4 for f32 and bf16 input alike
(every side upcasts bf16 exactly and computes in f32), argmax exact.
Ties are planted across vector, lane and slice boundaries; V = 1, V = 3,
odd V in bf16, rows off 16-byte alignment and slices that own no column
are covered; and the tolerance is shown to fail a dropped slice, a
missing rescale, a tie merge that keeps the later index and, at odd-V
bf16, a dropped head or tail.
"""
import re

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import entropy as entk  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import entropy as tent  # noqa: E402

F32_TOL = 1e-4          # chip_smoke.py, for f32 and bf16 input
NEG = -1e30             # the kernel's (and the TPU kernel's) start value
SMS = 132               # the H100 SXM's SM count
FAULTS = ("drop_slice", "no_rescale", "later_tie")


# ---------------------------------------------------------------------------
# the kernel's arithmetic, vectorised over threads: a state is (m, s, u,
# idx) tensors of one shape


def _neutral(n):
    return (torch.full((n,), NEG), torch.zeros(n), torch.zeros(n),
            torch.zeros(n, dtype=torch.long))


def _tie(a_idx, b_idx, fault):
    return (torch.maximum if fault == "later_tie" else torch.minimum)(
        a_idx, b_idx)


def _merge(a, b, fault=None):
    """The pairwise merge (one exp): the side with the larger maximum
    keeps its sums."""
    am, as_, au, ai = a
    bm, bs, bu, bi = b
    d = am - bm
    e = torch.exp(-d.abs())
    hi = d >= 0
    m = torch.where(hi, am, bm)
    s = torch.where(hi, as_ + bs * e, as_ * e + bs)
    u = torch.where(hi, au + bu * e, au * e + bu)
    idx = torch.where(d > 0, ai, torch.where(d < 0, bi, _tie(ai, bi, fault)))
    return m, s, u, idx


def _warp_reduce(st, lanes, fault=None):
    """Lane 0's result of the kernel's warp reduction over the last
    dimension (``lanes`` entries, a power of two)."""
    m, s, u, idx = st
    top = m.amax(-1, keepdim=True)
    c = torch.exp(m - top)
    s, u = s * c, u * c
    later = fault == "later_tie"
    fill = -1 if later else torch.iinfo(torch.long).max
    idx = torch.where(m == top, idx, torch.full_like(idx, fill))
    off = lanes // 2
    while off:
        s = s[..., :off] + s[..., off:2 * off]
        u = u[..., :off] + u[..., off:2 * off]
        idx = _tie(idx[..., :off], idx[..., off:2 * off], fault)
        off //= 2
    return top[..., 0], s[..., 0], u[..., 0], idx[..., 0]


def _lanes_for(n):
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _fold_round(st, x, cols, fault=None):
    """Fold rounds x [n, U*E] (NEG where a vector holds no data) at
    columns cols [n, U*E] (increasing) into the states: the round's
    maximum and its first column, then one rescale."""
    m, s, u, idx = st
    rm = x.amax(1)
    first = (x == rm[:, None]).int().argmax(1)
    if fault == "later_tie":
        first = x.shape[1] - 1 - (x.flip(1) == rm[:, None]).int().argmax(1)
    rc = cols.gather(1, first[:, None])[:, 0]
    new_m = torch.maximum(m, rm)
    e = torch.exp(x - new_m[:, None])
    c = torch.ones_like(m) if fault == "no_rescale" else torch.exp(m - new_m)
    idx = torch.where(rm > m, rc, torch.where(rm == m, _tie(idx, rc, fault),
                                              idx))
    return new_m, s * c + e.sum(1), u * c + (x * e).sum(1), idx


def _where(mask, a, b):
    return tuple(torch.where(mask, p, q) for p, q in zip(a, b))


def _slice_threads(row, addr, itemsize, k, splits, T, fault=None):
    """Every thread's state after slice k of ``splits`` of one row (f32
    values of a row that starts ``addr`` bytes past a 16-byte boundary),
    T threads: head element t, rounds of UNROLL vectors, tail element t."""
    V = row.numel()
    E = tent.VEC_BYTES // itemsize
    head = min(V, ((tent.VEC_BYTES - addr % tent.VEC_BYTES)
                   % tent.VEC_BYTES) // itemsize)
    nvec = (V - head) // E
    tail = head + nvec * E
    tid = torch.arange(T)
    st = _neutral(T)

    def scalar(first, count):
        c = (first + tid).clamp(max=V - 1)
        upd = _fold_round(st, row[c][:, None], c[:, None], fault)
        return _where(tid < count, upd, st)

    if k == 0 and fault != "drop_head":
        st = scalar(0, head)
    v0, v1 = nvec * k // splits, nvec * (k + 1) // splits
    U = tent.UNROLL
    for v in range(v0, v1, U * T):
        vec = v + tid[:, None] + T * torch.arange(U)[None, :]     # [T, U]
        valid = vec < v1
        cols = head + vec[..., None] * E + torch.arange(E)          # [T,U,E]
        x = torch.where(valid[..., None], row[cols.clamp(max=V - 1)],
                        torch.tensor(NEG))
        upd = _fold_round(st, x.reshape(T, -1), cols.reshape(T, -1), fault)
        st = _where(valid[:, 0], upd, st)
    if k == splits - 1 and fault != "drop_tail":
        st = scalar(tail, V - tail)
    return st


def _block_reduce(st, T, fault=None):
    """Thread 0's block partial: each warp's reduction, then warp 0's
    over the warps' results."""
    warps = T // 32
    st = _warp_reduce(tuple(t.reshape(warps, 32) for t in st), 32, fault)
    lanes = _lanes_for(warps)
    pad = _neutral(lanes - warps)
    st = tuple(torch.cat([a, b]) for a, b in zip(st, pad))
    return _warp_reduce(st, lanes, fault)


def _merge_slices(parts, fault=None):
    """The row's result from its slices' partials, in rank order: the
    last block's lane l folds slices l, l + 32, ..., then one warp
    reduction."""
    S = len(parts)
    if fault == "drop_slice":
        parts = parts[:S // 2] + parts[S // 2 + 1:] + [_neutral(1)]
    cat = tuple(torch.cat([p[i] for p in parts]) for i in range(4))
    lanes = _lanes_for(min(S, 32))
    acc = _neutral(32)
    for r0 in range(0, S, 32):
        n = min(32, S - r0)
        q = tuple(torch.cat([t[r0:r0 + n], z[n:]])
                  for t, z in zip(cat, _neutral(32)))
        acc = _where(torch.arange(32) < n, _merge(acc, q, fault), acc)
    return _warp_reduce(tuple(t[:lanes] for t in acc), lanes, fault)


def emulate(x: torch.Tensor, plan: dict, *, offset: int = 0, fault=None):
    """The kernel on logits x [B, V] (f32 or bf16) whose first row starts
    ``offset`` bytes past a 16-byte boundary, under ``plan`` (a dict as
    ``entropy_schedule`` returns) -> (entropy, max_prob, argmax int32)."""
    B, V = x.shape
    itemsize = x.element_size()
    xf = x.float()
    out = []
    for b in range(B):
        row = xf[b]
        addr = offset + b * V * itemsize
        if plan["schedule"] == "packed":
            N = plan["vector"]
            st = _neutral(1)
            for j in range(0, V, N):
                cols = torch.arange(j, j + N)[None, :]
                st = _fold_round(st, row[j:j + N][None, :], cols, fault)
        elif plan["schedule"] == "warp":
            st = _warp_reduce(_slice_threads(row, addr, itemsize, 0, 1, 32,
                                             fault), 32, fault)
        else:
            S, T = plan["splits"], plan["threads"]
            parts = [_block_reduce(_slice_threads(row, addr, itemsize, k, S,
                                                  T, fault), T, fault)
                     for k in range(S)]
            st = (_merge_slices([tuple(t[None] for t in p) for p in parts],
                                fault) if S > 1 else parts[0])
        out.append(tuple(t.reshape(()) for t in st))
    m, s, u, idx = (torch.stack([o[i] for o in out]) for i in range(4))
    return m + torch.log(s) - u / s, 1.0 / s, idx.to(torch.int32)


# ---------------------------------------------------------------------------


def _logits(B, V, seed, dtype="f32"):
    x = np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 4
    if dtype == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _check(got, want, tol):
    h, p, a = (t.float().numpy() if t.is_floating_point() else t.numpy()
               for t in got)
    hr, pr, ar = (np.asarray(w) for w in want)
    np.testing.assert_allclose(h, hr, rtol=tol, atol=tol)
    np.testing.assert_allclose(p, pr, rtol=tol, atol=tol)
    np.testing.assert_array_equal(a, ar)


def _split(threads, splits):
    return {"schedule": "split", "threads": threads, "splits": splits,
            "vector": None}


WARP = {"schedule": "warp"}


def test_schedule_of_the_main_path_and_the_vocabulary():
    for B in (64, 128):
        plan = tent.entropy_schedule(B, 2, 4, SMS)
        assert plan["schedule"] == "packed" and plan["blocks"] == 1
        assert plan["threads"] == B               # a thread a row
        assert plan["vector"] == 2                # a 2 x f32 row, one load
    plan = tent.entropy_schedule(300, 2, 4, SMS)
    assert plan["schedule"] == "packed" and plan["blocks"] == 2
    assert 300 % plan["threads"] != 0             # no block filled exactly
    plan = tent.entropy_schedule(8, 256000, 4, SMS)
    assert plan["schedule"] == "split" and plan["splits"] > 1
    assert 8 * plan["splits"] >= SMS
    assert plan["blocks"] == 8 * plan["splits"]
    # one round of UNROLL vectors a thread covers a slice
    assert plan["splits"] * plan["threads"] * tent.UNROLL >= 256000 // 4
    for B, V, itemsize in ((8, 2048, 2), (6, 1000, 4), (3, 257, 4)):
        plan = tent.entropy_schedule(B, V, itemsize, SMS)
        assert plan["schedule"] == "warp" and plan["threads"] == 32
        assert plan["vector"] == 16 // itemsize
    for B, V in ((64, 50304), (16, 50257), (1, 50304)):
        plan = tent.entropy_schedule(B, V, 4, SMS)
        assert plan["schedule"] == "split" and plan["splits"] > 1
        assert plan["threads"] == tent.SPLIT_THREADS
    # many long rows: a block a row, nothing to merge
    plan = tent.entropy_schedule(4096, 8192, 4, SMS)
    assert plan["schedule"] == "split" and plan["splits"] == 1
    # many medium rows: several rows a block
    assert tent.entropy_schedule(4096, 1000, 4, SMS)["threads"] == 8 * 32


@pytest.mark.parametrize("V,itemsize,offset,vector", [
    (2, 4, 0, 2), (2, 4, 8, 2), (2, 4, 4, 1), (3, 4, 0, 1), (1, 4, 0, 1),
    (16, 4, 0, 4), (8, 4, 8, 2), (2, 2, 0, 2), (1, 2, 0, 1), (16, 2, 0, 8),
    (16, 2, 6, 1)])
def test_packed_loads_divide_the_row_and_its_start(V, itemsize, offset,
                                                   vector):
    plan = tent.entropy_schedule(64, V, itemsize, SMS, offset=offset)
    assert plan["schedule"] == "packed" and plan["vector"] == vector
    assert V % vector == 0 and offset % (vector * itemsize) == 0


def test_schedule_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="B, V >= 1"):
        tent.entropy_schedule(0, 2, 4, SMS)
    with pytest.raises(ValueError, match="B, V >= 1"):
        tent.entropy_schedule(8, 0, 4, SMS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tent.entropy_stats_cuda(torch.zeros(2, 2))


def test_constants_match_the_cuda_source():
    src = (build.CSRC / "entropy.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kVecBytes") == tent.VEC_BYTES
    assert const("kUnroll") == tent.UNROLL
    assert "-use_fast_math" not in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in " ".join(build.NVCC_FLAGS)


# (B, V, dtype, plan, offset in bytes of the first row)
SMALL = [
    (5, 2, "f32", None, 0), (7, 1, "f32", None, 0), (4, 3, "f32", None, 0),
    (6, 16, "f32", None, 0), (6, 32, "f32", None, 0),
    (3, 5, "bf16", None, 0), (2, 2, "f32", None, 4),
    (3, 257, "f32", WARP, 0), (4, 1000, "f32", WARP, 0),
    (3, 2047, "bf16", WARP, 0), (3, 999, "f32", WARP, 4),
    (2, 1000, "f32", _split(64, 4), 0),
    (2, 1000, "f32", _split(32, 7), 4),
    (3, 1001, "bf16", _split(32, 5), 2),
    (2, 3001, "f32", _split(64, 3), 12),
    (2, 2500, "f32", _split(32, 40), 0),      # lanes fold 2 slices
    (2, 4100, "f32", _split(32, 70), 8),      # lanes fold 3 slices
    (2, 40, "f32", _split(32, 16), 0),        # slices with no column
    (2, 40, "f32", _split(32, 12), 8),
]


def _plan(B, V, dtype, plan, offset):
    return plan or tent.entropy_schedule(B, V, 2 if dtype == "bf16" else 4,
                                         SMS, offset=offset)


@pytest.mark.parametrize("B,V,dtype,plan,offset", SMALL)
def test_emulated_kernel_matches_ref_and_pallas(B, V, dtype, plan, offset):
    x = _logits(B, V, seed=V, dtype=dtype)
    got = emulate(_torch(x, dtype), _plan(B, V, dtype, plan, offset),
                  offset=offset)
    _check(got, ref.entropy_stats(_jax(x, dtype)), F32_TOL)
    _check(got, entk.entropy_stats(_jax(x, dtype), b_blk=8, v_blk=512,
                                   interpret=True), F32_TOL)


@pytest.mark.parametrize("B,V,dtype", [
    (8, 256000, "f32"), (16, 50257, "f32"), (8, 50257, "bf16"),
    (64, 50304, "f32")])
def test_emulated_kernel_at_the_card_shapes(B, V, dtype):
    """The plan the wrapper launches on a 132-SM card."""
    x = _logits(B, V, seed=1, dtype=dtype)
    x[0, [5, 600]] = 50.0                       # tied maximum in one row
    plan = tent.entropy_schedule(B, V, 2 if dtype == "bf16" else 4, SMS)
    _check(emulate(_torch(x, dtype), plan), ref.entropy_stats(_jax(x, dtype)),
           F32_TOL)


def _slice_start(V, splits, k, itemsize=4, offset=0):
    """The first column of slice k of an aligned-start row."""
    E = 16 // itemsize
    head = ((16 - offset % 16) % 16) // itemsize
    return head + (((V - head) // E) * k // splits) * E


# columns of row 0 of a 1005-wide f32 row that starts 4 bytes past a
# 16-byte boundary: a scalar head of 3, vectors of 4 from column 3 (lane
# l holds vectors l, l + 32, ...), a scalar tail of 2
TIES = {"head": (1, 2), "head_body": (2, 3), "vector": (3, 4),
        "lane": (6, 7), "round": (6, 131), "tail": (1003, 1004)}


@pytest.mark.parametrize("plan,where", [
    *((WARP, w) for w in TIES),
    (_split(32, 6), "slice"), (_split(64, 6), "slice"),
    (_split(32, 6), "last_slice"), (_split(64, 6), "last_slice"),
    (_split(64, 3), "vector"), ("packed", "vector")])
def test_first_index_wins_a_tie_across_every_boundary(plan, where):
    V, offset = (8, 0) if plan == "packed" else (1005, 4)
    x = _logits(3, V, seed=7)
    if plan == "packed":
        plan = tent.entropy_schedule(3, V, 4, SMS, offset=offset)
        first, second = 3, 4                # the end of one load, the next
        assert first // plan["vector"] != second // plan["vector"]
    elif where in TIES:
        first, second = TIES[where]
    else:
        k = 3 if where == "slice" else 5
        second = _slice_start(V, 6, k, offset=offset)
        first = second - 1
    x[:, [first, second]] = 50.0
    x[2, [0, V - 1]] = 50.0                 # first and last column
    got = emulate(_torch(x, "f32"), plan, offset=offset)
    assert got[2].tolist() == [first, first, 0]
    _check(got, ref.entropy_stats(_jax(x, "f32")), F32_TOL)


@pytest.mark.parametrize("fault", FAULTS)
def test_f32_tol_fails_a_planted_fault(fault):
    """A dropped slice or a missing rescale moves entropy and max_prob by
    more than F32_TOL; a tie merge that keeps the later index moves the
    argmax.  The clean emulation of the same plan passes."""
    B, V = 4, 4000
    x = _logits(B, V, seed=3)
    # slice 1 of 2 holds vectors 500-999, four rounds of each thread's:
    # column 3000 (vector 750) is a new maximum in thread 26's second round
    x[:, 3000] = 9.0
    b = _slice_start(V, 2, 1)
    x[0, [b - 1, b]] = 50.0          # tie across slices 0 and 1
    x[1, [13, 14]] = 50.0            # tie inside one vector
    plan = _split(32, 2)
    want = ref.entropy_stats(_jax(x, "f32"))
    _check(emulate(_torch(x, "f32"), plan), want, F32_TOL)
    with pytest.raises(AssertionError):
        _check(emulate(_torch(x, "f32"), plan, fault=fault), want, F32_TOL)


@pytest.mark.parametrize("fault", ("drop_slice", "drop_head", "drop_tail"))
def test_f32_tol_fails_a_planted_fault_at_odd_v_bf16(fault):
    """8 x 50257 bf16 under the card's plan (17 slices, rows off 16-byte
    alignment): a dropped slice, or a lost scalar head or tail, moves
    entropy and max_prob by more than F32_TOL, which ``chip_smoke.py``
    holds bf16 input to.  The clean emulation passes."""
    B, V = 8, 50257
    plan = tent.entropy_schedule(B, V, 2, SMS)
    assert plan["schedule"] == "split" and plan["splits"] == 17
    x = _logits(B, V, seed=4, dtype="bf16")
    x[:, 3] = 24.0                   # row 1 on: inside the scalar head
    x[:, V - 1] = 24.0               # row 0 on: inside the scalar tail
    want = ref.entropy_stats(_jax(x, "bf16"))
    _check(emulate(_torch(x, "bf16"), plan), want, F32_TOL)
    with pytest.raises(AssertionError):
        _check(emulate(_torch(x, "bf16"), plan, fault=fault), want, F32_TOL)
