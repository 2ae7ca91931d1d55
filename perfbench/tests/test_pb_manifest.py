"""``BENCHMARK.json`` against the benchmark's contract: names, units,
files, metrics and the cells that report them."""
import json
import re
from pathlib import Path

import pytest

from perfbench.lib import describe, weights

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_and_paths():
    assert set(B) == KEYS
    assert 1 <= len(B["paths"]) <= 16 and len(B["command"]) <= 32
    for p in B["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert not p.endswith("_torch") and ".." not in p
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len(json.dumps(B)) <= 64 * 1024


def test_check_fits_its_time_with_24_cells():
    rs = B["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(group):
    names = [e["name"] for e in B[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for e in B[group]:
        for k in ("why", "layer", "source"):
            if k in e and k != "source" or (k == "source" and group == "configs"):
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_configs_and_cells_have_their_files():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "checks" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, len(B["workloads"]) // 4)


@pytest.mark.parametrize("conf", [c["file"] for c in B["configs"]])
def test_each_configuration_module_has_the_contract(conf):
    """The module a configuration names (``reference/lm.py`` without the
    key) exists and defines the seven functions the harness reads."""
    f = json.loads((ROOT / conf).read_text())
    assert (ROOT / "perfbench" / f.get("reference", "reference/lm.py")).is_file()
    ref = describe.load(f)
    for name in ("dims", "specs", "logits", "cache_row_bytes", "matmul_params",
                 "attention_flops", "decode_attention_bytes"):
        assert callable(getattr(ref, name, None)), name
    assert {"L", "V", "dtype"} <= set(ref.dims(f["model"]))
    assert {k for _, _, k in ref.specs(f["model"])} <= set(weights.KINDS)


def test_metrics_well_formed_with_readers():
    cells = {w["name"] for w in B["workloads"]}
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert (m["bound"] <= 0.25 and (m["bound"] >= 0.01))
    setup = next(m for m in B["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_each_moves_is_reported_wherever_its_metric_is():
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in B["end_to_end"]}
    layers = {}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m["name"]
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in B["workloads"]:
        n = w["name"]
        e2e = [m["name"] for m in B["end_to_end"] if n in m.get("workloads", [n])]
        per = [m["name"] for m in B["per_layer"] if n in m.get("workloads", [n])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
