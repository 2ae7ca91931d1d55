"""The operation and byte counts at shapes worked out by hand, each through
the configuration's reference module, as the metric readers take them."""
import json
import math
from pathlib import Path

from perfbench.lib import bench, describe, flops, readers

CONF = Path(__file__).resolve().parents[1] / "configs"


def _module(name):
    """(the configuration's reference module, its sizes)."""
    f = json.loads((CONF / f"{name}.json").read_text())
    ref = describe.load(f)
    return ref, ref.dims(f["model"])


def test_stablelm_parameters_per_token():
    ref, z = _module("stablelm-3b")
    layer = 4 * 2560 * 2560 + 3 * 2560 * 6912          # 26,214,400 + 53,084,160
    assert ref.matmul_params(z) == 32 * layer + 2560 * 50304 == 2_666_332_160
    assert readers.model_flops(ref, z, 1, 0, 0, 0) == 5_332_664_320


def test_granite_active_parameters_per_token():
    ref, z = _module("granite-moe-3b-a800m")
    attn = 1536 * (24 + 16) * 64 + 24 * 64 * 1536      # 6,291,456
    experts = 8 * 3 * 1536 * 512 + 1536 * 40           # 18,874,368 + 61,440
    assert ref.matmul_params(z) == 32 * (attn + experts) + 1536 * 49155
    assert 0.87e9 < ref.matmul_params(z) < 0.89e9


def test_attention_counts():
    ref, z = _module("stablelm-3b")
    # one 1,536-token prompt: 32 layers x 32 heads x 80 x 4 x 1536*1537/2
    assert flops.causal_pairs(1536) == 1_180_416
    assert ref.attention_flops(z, 1_180_416) == 4 * 32 * 80 * 32 * 1_180_416
    # decode: 32 slots at 700 valid rows, K/V of 32 heads of 80 in bf16
    b = ref.decode_attention_bytes(z, 32 * 700, 32)
    assert b == 2 * 32 * (2 * 32 * 80 * 32 * 700 + 2 * 32 * 80 * 32)
    assert math.isclose(b / (32 * 700), 327_680, rel_tol=2e-3)   # a token's K/V


def test_cache_row_bytes():
    """A cached token over every layer: stablelm 32 x 2 x 32 x 80 x 2 B,
    granite 32 x 2 x 8 x 64 x 2 B."""
    for name, row in (("stablelm-3b", 327_680), ("granite-moe-3b-a800m", 65_536)):
        ref, z = _module(name)
        assert ref.cache_row_bytes(z) == row


def test_decode_rows_of_an_advance():
    """A request seated at a padded length of 100 that got tokens 0..8 in
    one advance: 8 decode steps over 101..108 valid rows; then tokens
    9..16 over 109..116."""
    assert bench.decode_rows(100, 1, 9) == sum(range(101, 109))
    assert bench.decode_rows(100, 9, 17) == sum(range(109, 117))
