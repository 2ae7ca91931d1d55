"""The port's attention kernel modules against the reference, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against their plain versions there).  Here the plain versions,
``flash_attention_plain`` and ``decode_attention_plain``, are held
against ``repro.kernels.ref`` AND against the TPU kernels in interpret
mode, on the same numpy inputs: GQA (H=8, K=2) and MHA, hd 32 and 80,
a window, ``q_offset``, a ring-buffer ``kv_pos``, and lengths that are
not a multiple of the TPU kernel's blocks (run at q_blk 16 / k_blk 32
so that small shapes still span several blocks).  f32 to 1e-4 and bf16
to 3e-2, the tolerances of ``tests/test_kernels.py``.  A decode slot
with no valid key is skipped: the TPU kernel gives the mean of its
rows, ``ref`` the mean of all rows, the CUDA kernel 0, and nothing
reads that output.
"""
import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

TOL = {"f32": 1e-4, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}

# (B, H, K, Sq, Skv, hd, causal, window, q_offset)
FLASH = {
    "gqa_ragged_hd32": (2, 8, 2, 37, 37, 32, True, 0, 0),
    "mha_hd80_offset": (1, 4, 4, 24, 40, 80, True, 0, 16),
    "gqa_hd80_window": (2, 8, 2, 48, 48, 80, True, 9, 0),
    "mha_hd32_full": (1, 4, 4, 33, 33, 32, False, 0, 0),
}
# (B, H, K, S, hd, window, layout, q dtype, k/v dtype)
DECODE = {
    "gqa_prefix_hd32": (3, 8, 2, 37, 32, 0, "prefix", "f32", "f32"),
    "mha_ring_window_hd80": (2, 4, 4, 64, 80, 16, "ring", "f32", "f32"),
    "gqa_hd80_bf16": (3, 8, 2, 50, 80, 0, "prefix", "bf16", "bf16"),
    "mha_hd32_f32q_bf16kv": (4, 4, 4, 40, 32, 0, "prefix", "f32", "bf16"),
    "gqa_ring_window_bf16": (2, 8, 2, 45, 32, 20, "ring", "bf16", "bf16"),
}


def _arr(shape, seed, dt):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dt]), torch.from_numpy(x).to(TDT[dt])


def _close(got, want, tol, rows=None):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_plain_matches_ref_and_tpu_kernel(case, dt):
    B, H, K, Sq, Skv, hd, causal, window, off = FLASH[case]
    jq, tq = _arr((B, H, Sq, hd), 0, dt)
    jk, tk = _arr((B, K, Skv, hd), 1, dt)
    jv, tv = _arr((B, K, Skv, hd), 2, dt)
    kw = dict(causal=causal, window=window, q_offset=off)
    got = tfa.flash_attention_plain(tq, tk, tv, **kw)
    assert got.dtype == TDT[dt] and got.shape == (B, H, Sq, hd)
    _close(got, ref.flash_attention(jq, jk, jv, **kw), TOL[dt])
    _close(got, jfa.flash_attention(jq, jk, jv, q_blk=16, k_blk=32,
                                    interpret=True, **kw), TOL[dt])
    # the dispatch on a CPU tensor, fed BHSD views of BSHD storage as the
    # model feeds it, gives the same numbers
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (tq, tk, tv)]
    for impl in ("auto", "ref"):
        torch.testing.assert_close(ops.flash_attention(*views, impl=impl,
                                                       **kw), got)


def _positions(B, S, layout, seed):
    """kv_pos [B,S] and cur [B]: a valid prefix then -1 (slot 0 of the
    prefix layout is left empty), or a ring written past its extent."""
    rng = np.random.default_rng(seed)
    col = np.arange(S)[None]
    if layout == "prefix":
        n = rng.integers(1, S + 1, size=B)
        n[0] = 0
        kv = np.where(col < n[:, None], col, -1)
        cur = np.maximum(n - 1, 0)
    else:
        cur = rng.integers(S, 3 * S, size=B)
        kv = cur[:, None] - ((cur[:, None] - col) % S)   # row i holds i mod S
    return kv.astype(np.int32), cur.astype(np.int32)


@pytest.mark.parametrize("case", sorted(DECODE))
def test_decode_plain_matches_ref_and_tpu_kernel(case):
    B, H, K, S, hd, window, layout, qdt, kdt = DECODE[case]
    jq, tq = _arr((B, H, hd), 3, qdt)
    jk, tk = _arr((B, K, S, hd), 4, kdt)
    jv, tv = _arr((B, K, S, hd), 5, kdt)
    kv, cur = _positions(B, S, layout, 6)
    tkv, tcur = torch.from_numpy(kv), torch.from_numpy(cur)
    got = tda.decode_attention_plain(tq, tk, tv, tkv, tcur, window=window)
    assert got.dtype == TDT[qdt] and got.shape == (B, H, hd)
    valid = tda.valid_rows(tkv, tcur, window).numpy()
    assert (valid == ((kv >= 0) & (kv <= cur[:, None])
                      & ((cur[:, None] - kv < window) if window
                         else True))).all()
    rows = valid.any(axis=1)
    assert rows.sum() >= B - 1
    tol = TOL["f32" if qdt == kdt == "f32" else "bf16"]
    jkv, jcur = jnp.asarray(kv), jnp.asarray(cur)
    _close(got, ref.decode_attention(jq, jk, jv, jkv, jcur, window=window),
           tol, rows)
    _close(got, jda.decode_attention(jq, jk, jv, jkv, jcur, window=window,
                                     k_blk=16, interpret=True), tol, rows)
    # the model's BSHD cache, read through transposed views
    kc = tk.transpose(1, 2).contiguous().transpose(1, 2)
    vc = tv.transpose(1, 2).contiguous().transpose(1, 2)
    for impl in ("auto", "ref"):
        torch.testing.assert_close(
            ops.decode_attention(tq, kc, vc, tkv, tcur, window=window,
                                 impl=impl), got)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_impls():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.decode_attention(q[:, :, 0], q, q,
                             torch.zeros(1, 4, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32), impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, q, q, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(q[:, :, 0], q, q, None, None, impl="xla")


def test_attention_sources_are_built_together():
    """Every attention source is in the parallel build list, and its
    library path follows its own source and the flags."""
    assert {"entropy", "flash_attention", "decode_attention"} <= set(
        build.KERNELS)
    for name in ("flash_attention", "decode_attention"):
        src = build.CSRC / f"{name}.cu"
        assert src.exists()
        assert name in build.library_path(name).name
        cmd = build.nvcc_command("nvcc", name, build.library_path(name))
        assert "-gencode=arch=compute_90a,code=sm_90a" in cmd
        assert cmd[-1] == str(src)
