"""A configuration that brings its own reference module: ``smoke-plug``
names ``tests/data/latent_moe.py``, a decoder with a latent K/V normed at
its own width and a shared expert beside sigmoid-routed ones, layers
``reference/lm.py`` does not describe.  The harness's generic code takes
it as it is: seeded weights, the judge, the control, the cache's bytes
and both counting readers.  And no file of the harness names a layout."""
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.lib import bench, describe, readers, traffic
from perfbench.lib import weights as wts
from perfbench.reference import control
from perfbench.run import load_reader

PB = Path(__file__).resolve().parents[1]
CONF = json.loads((PB / "tests" / "data" / "smoke-plug.json").read_text())
M = CONF["model"]
SEED = 2 ** 33 + 7


@pytest.fixture(scope="module")
def ref():
    return describe.load(CONF)


def _served(ref, seed):
    """Three requests whose tokens are the module's own greedy choices,
    each prompt right-padded with 0 to its wave's length, as served."""
    z = ref.dims(M)
    w = wts.make(ref, M, seed, "cpu")
    weight = lambda n: w[n].float()
    rng = traffic.rng_of(seed, 3)
    out = []
    for rid, (n_prompt, plen, n_new) in enumerate(((5, 8, 12), (9, 9, 7), (14, 16, 20))):
        prompt = rng.integers(0, z["V"], n_prompt).astype(np.int32)
        seq = torch.zeros(plen, dtype=torch.int64)
        seq[:n_prompt] = torch.as_tensor(prompt)
        gen = []
        for _ in range(n_new):
            t = int(ref.logits(z, weight, seq, torch.tensor([len(seq) - 1]))[0].argmax())
            gen.append(t)
            seq = torch.cat([seq, torch.tensor([t])])
        out.append((traffic.Spec(rid=rid, prompt=prompt, max_new=n_new), plen, gen))
    return out


def test_weights_by_kind_from_its_specs(ref):
    w = wts.make(ref, M, SEED, "cpu")
    sp = ref.specs(M)
    assert list(w) == [n for n, _, _ in sp]
    assert all(tuple(w[n].shape) == s and k in wts.KINDS for n, s, k in sp)
    assert w["layers.1.attn.kv_norm"].shape == (24,)          # a norm not of width d
    assert w["layers.0.moe.shared_gate"].dtype == torch.float32
    again = wts.make(ref, M, SEED, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)
    assert not torch.equal(w["emb"], wts.make(ref, M, SEED + 1, "cpu")["emb"])


def test_unknown_kind_is_refused():
    class Bad:
        specs = staticmethod(lambda m: [("x", (2, 2), "lowrank")])
        dims = staticmethod(lambda m: {"dtype": torch.float32})
    with pytest.raises(ValueError, match="lowrank"):
        wts.make(Bad, {}, 1, "cpu")


def test_judge_reads_its_own_greedy_tokens_exactly(ref):
    served = _served(ref, SEED)
    readings, compared, worst = bench.judge(ref, M, SEED, served, "cpu")
    assert readings == {"logit_gap": 0.0, "mean_logit_gap": 0.0}
    assert compared == 12 + 7 + 20 and worst is None


def test_control_reads_above_zero(ref):
    served = _served(ref, SEED)
    assert control.control_readings(ref, M, SEED, served, "cpu")["logit_gap"] > 0


def test_cache_bytes_and_both_counting_readers(ref):
    z = ref.dims(M)
    row = 2 * 24 * 4                                            # the latent, 2 layers
    kv = bench.kv_bytes(ref, z, 4, 64, kv_rows=4 * 30 * 10, steps=10)
    assert kv == {"pool": 4 * 64 * row, "live": 4 * 30 * row}
    attn = 64 * 64 + 64 * 24 + 2 * 24 * 64 + 64 * 64
    mix = 2 * 3 * 64 * 32 + 64 * 4 + 3 * 64 * 48
    params = 2 * (attn + mix) + 64 * 256
    assert ref.matmul_params(z) == params
    work = bench.Tally(prompt_tokens=30, prompt_pairs=465, decode_tokens=40,
                       decode_pairs=2000, kv_rows=2000)
    flop = 2 * params * 70 + 4 * 4 * 16 * 2 * (465 + 2000)
    assert readers.model_flops(ref, z, 30, 465, 40, 2000) == flop
    rec = {"ref": ref, "config": z, "work": work, "window_s": 2.0,
           "trace": {"kernel_s": {"decode_kernel_gqa<float, 4>": 1e-6, "gemm": 5.0}}}
    assert math.isclose(load_reader("mfu_pct.backlog")(rec),
                        100 * flop / 2.0 / 989e12)
    byte = 2 * 4 * (24 * 2000 + 2 * 64 * 40)
    least = max(4 * 4 * 16 * 2 * 2000 / 989e12, byte / 3.35e12)
    assert math.isclose(load_reader("decode_attention_roofline")(rec), 100 * least / 1e-6)


HARNESS = ([PB / "control.py", PB / "run.py", PB / "reference" / "control.py"]
           + sorted((PB / "lib").glob("*.py")) + sorted((PB / "metrics").glob("*.py")))
LAYOUT = re.compile(r"latent_moe|smoke-plug|reference import lm|reference\.lm|ref_lm"
                    r"|\b(?:weights|wts)\.(?:specs|dims)\b"
                    r"|\bflops\.(?:matmul_params|token_flops|attention_flops"
                    r"|decode_attention_bytes)\b|\b(?:family|arch_id)\b")


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(PB)))
def test_no_harness_file_names_a_layout(path):
    """Only the loader names the default module; nothing picks a layout."""
    text = path.read_text()
    assert not LAYOUT.search(text), LAYOUT.search(text).group(0)
    assert "lm.py" not in text or path.name == "describe.py"


@pytest.mark.parametrize("bad", ["../configs/x.py", "/abs/lm.py", "reference/lm.txt",
                                 "reference/none.py"])
def test_reference_path_refused(bad):
    with pytest.raises((ValueError, FileNotFoundError)):
        describe.load({"reference": bad})
