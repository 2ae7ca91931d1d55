"""The port's entropy kernel module against the reference, on the CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``entropy_stats_plain`` there); here the plain version is held
against the TPU kernel in interpret mode and against the JAX oracle,
and the dispatch, the wrapper's refusals and the build are checked.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import entropy as entk  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import build, ops, runtime  # noqa: E402
from repro_torch.kernels import entropy as tent  # noqa: E402

# tests/test_kernels.py:19-25, plus the main path's V = n_classes = 2
SHAPES = [(4, 1000, "f32"), (16, 4096, "f32"), (3, 257, "f32"),
          (8, 2048, "bf16"), (1, 50_304, "f32"), (64, 2, "f32")]
TOL = {"f32": 1e-4, "bf16": 3e-2}


def _logits(B, V, seed=0):
    """Seeded f32 logits; row 0 gets a tied maximum across 512-wide
    kernel blocks, so the first index must win."""
    x = np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 4
    if V > 700:
        x[0, [5, 600]] = 50.0
    elif V == 2:
        x[0] = 1.25
    return x


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _check(got, want, tol):
    h, p, a = (t.float().numpy() if t.is_floating_point() else t.numpy()
               for t in got)
    hr, pr, ar = (np.asarray(w) for w in want)
    np.testing.assert_allclose(h, hr, rtol=tol, atol=tol)
    np.testing.assert_allclose(p, pr, rtol=tol, atol=tol)
    np.testing.assert_array_equal(a, ar)
    assert a.dtype == np.int32


@pytest.mark.parametrize("B,V,dtype", SHAPES)
def test_plain_entropy_matches_pallas_kernel(B, V, dtype):
    xj, xt = _pair(_logits(B, V), dtype)
    want = entk.entropy_stats(xj, b_blk=8, v_blk=512, interpret=True)
    _check(tent.entropy_stats_plain(xt), want, TOL[dtype])


@pytest.mark.parametrize("B,V,dtype", SHAPES)
def test_plain_entropy_matches_jax_ref(B, V, dtype):
    xj, xt = _pair(_logits(B, V, seed=1), dtype)
    _check(tent.entropy_stats_plain(xt), ref.entropy_stats(xj), TOL[dtype])


def test_plain_entropy_first_index_wins_ties():
    x = np.zeros((3, 1000), np.float32)
    x[0, [3, 700]] = 9.0
    x[1, [5, 261]] = 9.0
    x[2, [998, 999]] = 9.0
    _, _, a = tent.entropy_stats_plain(torch.from_numpy(x))
    assert a.tolist() == [3, 5, 998]
    _, _, a_tpu = entk.entropy_stats(jnp.asarray(x), v_blk=512,
                                     interpret=True)
    assert np.asarray(a_tpu).tolist() == [3, 5, 998]


def test_ops_dispatch_on_cpu_tensors():
    x = torch.from_numpy(_logits(5, 300))
    before = tent.launches
    want = tent.entropy_stats_plain(x)
    for impl in ("auto", "ref"):
        got = ops.entropy_stats(x, impl=impl)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert tent.launches == before          # no kernel ran on the CPU
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.entropy_stats(x, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        ops.entropy_stats(x, impl="pallas")


def test_runtime_sets_full_precision_matmuls():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        runtime.resolve_device("meta")


def test_on_hopper_needs_cuda_and_sm90(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert runtime.on_hopper() is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cap, want in (((9, 0), True), ((8, 0), False), ((10, 0), False)):
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda device=None, cap=cap: cap)
        assert runtime.on_hopper() is want


def test_build_targets_sm90a_and_needs_nvcc(monkeypatch, tmp_path):
    cmd = build.nvcc_command("nvcc", "entropy", tmp_path / "e.so")
    assert "-gencode=arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("csrc/entropy.cu")
    lib = build.library_path("entropy", tmp_path)
    assert lib.parent == tmp_path and lib.name.startswith("entropy-")
    assert lib == build.library_path("entropy", tmp_path)   # stable hash
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(FileNotFoundError, match="nvcc"):
        build.build_all(("entropy",), tmp_path / "out")
