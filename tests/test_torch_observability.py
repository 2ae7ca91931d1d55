"""The port's observability layer on the CPU: the energy-drift audit
(and the NVML source's refusal where NVIDIA's library is absent),
the run exporter, the build and capture watcher that stands in for the
reference's XLA compile watcher, the trace validator's CLI, and the
launcher's fleet, chaos and live-fleet runs with their trace and
metrics written and validated.  The claims are those of the reference's
``tests/test_trace.py`` (energy drift, export, compile watcher) on the
port's counterparts."""
import ctypes
import ctypes.util
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from port_threads import share_cores  # noqa: E402

share_cores()

from repro_torch.kernels import build, graphs  # noqa: E402
from repro_torch.launch import compile_cache  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.telemetry import (CompileWatcher,  # noqa: E402
                                   EnergyDriftAudit, MetricsRegistry,
                                   NvmlSource, ProcessTimeSource, Tracer,
                                   Tracker, VirtualClock,
                                   export_observability,
                                   make_measured_source, validate_chrome,
                                   validate_trace)
from repro_torch.telemetry.validate import main as validate_main  # noqa: E402
from repro_torch.telemetry.validate import (  # noqa: E402
    validate_metrics_snapshot)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _nested(tracer):
    root = tracer.begin("request", 0.0, rid=1)
    child = tracer.span("prefill", 0.1, 0.4, parent=root,
                        resource="prefill-0")
    tracer.end(root, 1.0)
    return root, child


# ---------------------------------------------------------------------------
# energy drift audit and its measured sources


def test_energy_drift_audit_reports_ratio():
    class Fake:
        name = "fake"
        j = 0.0

        def read_j(self):
            return self.j

    src = Fake()
    audit = EnergyDriftAudit(source=src).start()
    src.j = 50.0                               # measured 50 J
    audit.record(100.0, n_requests=10)         # modelled 100 J
    rep = audit.stop()
    assert rep["drift_ratio"] == pytest.approx(2.0)
    assert rep["modelled_j_per_request"] == pytest.approx(10.0)
    m = MetricsRegistry()
    audit.export(m)
    assert m.gauge("energy_drift_ratio").value(
        source="fake") == pytest.approx(2.0)


def test_process_time_source_monotone():
    src = ProcessTimeSource(p_active_w=100.0)
    a = src.read_j()
    sum(i * i for i in range(20000))           # burn a little CPU
    assert src.read_j() >= a


def _nvml_opens() -> bool:
    try:
        ctypes.CDLL(NvmlSource.LIBRARY)
    except OSError:
        return False
    return True


@pytest.mark.parametrize("kind", ["nvml", "tpu"])
def test_measured_source_refuses_without_its_library(kind):
    """Where ``libnvidia-ml.so.1`` cannot be opened the NVML source
    raises (it never falls back to process time); the TPU source
    raises as the reference's does."""
    if kind == "nvml" and _nvml_opens():
        pytest.skip("NVIDIA's NVML library opens here; its refusal "
                    "needs a machine without it")
    with pytest.raises(RuntimeError):
        make_measured_source(kind)


def test_nvml_source_names_a_missing_symbol():
    """A library without NVML's symbols is refused by name."""
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for NVML")
    with pytest.raises(RuntimeError, match="nvmlInit_v2"):
        NvmlSource(library=libc)
    with pytest.raises(ValueError):
        make_measured_source("joules-from-nowhere")


# ---------------------------------------------------------------------------
# run exporter


def test_export_observability_lands_artifacts(tmp_path):
    tr = Tracer(clock=VirtualClock())
    _nested(tr)
    m = MetricsRegistry()
    m.gauge("fleet_pressure").set(0.1, replica="r0")
    audit = EnergyDriftAudit(source=ProcessTimeSource()).start()
    audit.record(1.0, 1)
    audit.stop()
    run = Tracker(root=str(tmp_path)).start_run("obs")
    paths = export_observability(run, tracer=tr, metrics=m, audit=audit)
    run.finish()
    assert set(paths) == {"trace", "metrics", "prometheus", "drift"}
    with open(paths["trace"]) as f:
        assert validate_chrome(json.load(f)) == []
    with open(paths["drift"]) as f:
        rep = json.load(f)
    assert rep["source"] == "process-time"
    assert math.isfinite(rep["modelled_j"])


# ---------------------------------------------------------------------------
# build and capture watcher (cuda.build / cuda.capture spans, the
# compile_seconds gauge)


class _StubGraph:
    def replay(self):
        pass


class _StubContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def kernel_logs(monkeypatch, tmp_path):
    """Fresh build and capture logs, a build directory of its own, and an
    ``nvcc`` that writes an empty library in 1.25 s of its own clock."""
    monkeypatch.setattr(build, "build_log", [])
    monkeypatch.setattr(build, "hit_log", [])
    monkeypatch.setattr(build, "build_seconds", {})
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(graphs, "capture_log", [])
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")

    def fake_run(cmd):
        with open(cmd[cmd.index("-o") + 1], "wb"):
            pass
        return 0, "ptxas info: 0 bytes spill", 1.25

    monkeypatch.setattr(build, "_run", fake_run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    return tmp_path


def test_compile_watcher_exports_builds_captures_and_hits(kernel_logs):
    w = CompileWatcher().install()
    build.build_all(("entropy", "ssd_scan"))           # two nvcc runs
    g = graphs.CountedGraph(graph=_StubGraph())
    g.capture(lambda: None, context=_StubContext())     # one capture
    tracer, metrics = Tracer(), MetricsRegistry()
    report = w.export(tracer, metrics)
    assert report["compile_count"] == 2
    assert report["compile_seconds"] == pytest.approx(2.5)
    assert report["capture_count"] == 1 and report["cache_hits"] == 0
    builds = tracer.find("cuda.build")
    assert sorted(s.attrs["library"] for s in builds) == ["entropy",
                                                          "ssd_scan"]
    assert {s.resource for s in builds} == {"cuda.build/entropy",
                                            "cuda.build/ssd_scan"}
    assert len(tracer.find("cuda.capture")) == 1
    assert validate_trace(tracer.spans) == []          # no overlap
    snap = metrics.snapshot()
    assert snap["gauges"]["compile_seconds"][0]["value"] == pytest.approx(2.5)
    events = {s["labels"]["kind"]: s["value"]
              for s in snap["counters"]["compile_events"]}
    assert events == {"nvcc": 2, "capture": 1}

    # warm start (a new process: nothing built or opened yet): the
    # libraries are found as built; nothing compiles, the gauge is
    # still set, at 0.0, and the hits are counted
    build.build_seconds.clear()
    build._libs.clear()
    w2 = CompileWatcher().install()
    build.load("entropy")
    build.load("ssd_scan")
    m2 = MetricsRegistry()
    report2 = w2.export(None, m2)
    snap2 = m2.snapshot()
    assert snap2["gauges"]["compile_seconds"][0]["value"] == 0.0
    assert report2["cache_hits"] == 2 and report2["compile_count"] == 0
    assert snap2["counters"]["compile_cache_hits"][0]["value"] == 2


def test_compile_watcher_sees_nothing_when_not_installed(kernel_logs):
    w = CompileWatcher()                               # NOT installed
    build.build_all(("entropy",))
    assert w.compile_count == 0 and w.compile_seconds == 0.0
    assert w.export(None, MetricsRegistry())["compile_count"] == 0


def test_compile_cache_moves_the_build_directory(kernel_logs, tmp_path):
    default = compile_cache.DEFAULT_DIR
    assert default.parts[-2:] == ("build", "torch_kernels")
    assert compile_cache.resolve_cache_dir(None) == default
    assert compile_cache.resolve_cache_dir("") == default
    where = compile_cache.enable_compilation_cache(str(tmp_path / "cache"))
    assert where == tmp_path / "cache" and where.is_dir()
    assert build.library_path("entropy").parent == where
    build.build_all(("entropy",))
    assert build.library_path("entropy").exists()


# ---------------------------------------------------------------------------
# the validator's CLI and the metrics snapshot


def test_validate_cli_accepts_a_trace_and_rejects_a_broken_one(tmp_path):
    tr = Tracer(clock=VirtualClock())
    _nested(tr)
    good = tmp_path / "good.json"
    tr.write_chrome(str(good))
    doc = json.loads(good.read_text())
    doc["traceEvents"].append({"name": "x", "ph": "X", "ts": 0.0,
                               "dur": -5.0, "pid": 1, "tid": 1,
                               "args": {"parent_id": "nowhere"}})
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.telemetry.validate"]
    ok = subprocess.run(cmd + [str(good)], capture_output=True, text=True,
                        env=env, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert ok.stdout.startswith("ok:")
    no = subprocess.run(cmd + [str(bad)], capture_output=True, text=True,
                        env=env, timeout=120)
    assert no.returncode == 1
    assert "INVALID" in no.stderr
    assert validate_metrics_snapshot({}) != []


# ---------------------------------------------------------------------------
# the launcher on the CPU: fleet, chaos, live fleet


@pytest.mark.parametrize("flags", [
    ["--fleet", "--requests", "200"],
    ["--fleet", "--chaos", "crash-storm", "--requests", "200"],
    ["--fleet-live", "--requests", "64"],
], ids=["fleet", "chaos", "fleet-live"])
def test_launcher_fleet_runs_write_valid_artifacts(flags, tmp_path, capsys):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    tserve.main(["--device", "cpu", *flags, "--runs", str(tmp_path / "runs"),
                 "--trace-out", str(trace), "--metrics-out", str(metrics)])
    out = json.loads(capsys.readouterr().out)
    n = int(flags[flags.index("--requests") + 1])
    assert out["n"] == n and out["device"] == "cpu"
    assert sum(out["routed"].values()) >= n - out["n_rejected"]
    assert out["live"] == ("--fleet-live" in flags)
    drift = out["energy_drift"]
    assert drift["source"] == "process-time"
    assert drift["modelled_j"] == pytest.approx(out["energy_j"])
    assert drift["compile"]["compile_seconds"] == 0.0
    if "--chaos" in flags:
        assert out["chaos"] == "crash-storm" and out["n_failures"] == 2
        assert out["n_served"] + out["n_rejected"] == n
    assert validate_main([str(trace), str(metrics), "--require-gauge",
                          "compile_seconds", "energy_drift_ratio",
                          "fleet_pressure"]) == 0
    assert (tmp_path / "metrics.prom").exists()


def test_launcher_fleet_refusals(tmp_path):
    if not torch.cuda.is_available():
        # the default device is the card: no quiet serving on the CPU
        with pytest.raises(RuntimeError, match="needs CUDA"):
            tserve.main(["--fleet-live", "--requests", "8",
                         "--runs", str(tmp_path)])
    if not _nvml_opens():
        with pytest.raises(RuntimeError, match="NVML"):
            tserve.main(["--device", "cpu", "--fleet", "--requests", "8",
                         "--runs", str(tmp_path), "--energy-source",
                         "nvml", "--metrics-out", str(tmp_path / "m.json")])
    with pytest.raises(SystemExit, match="does not use --path"):
        tserve.main(["--device", "cpu", "--fleet", "--path", "gated"])
    with pytest.raises(SystemExit, match="unknown replica kind"):
        tserve.main(["--device", "cpu", "--fleet-live", "--fleet-kinds",
                     "continuous-decode", "--runs", str(tmp_path)])
