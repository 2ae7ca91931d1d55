"""Experiment tracker — the MLflow analogue (paper §III-C, §X).

File-backed runs: params, step metrics, artifacts; CSV export "for
audit" exactly as the paper's reproducibility notes require.  No
server; a run is a directory under ``runs/``.
"""
from __future__ import annotations

import csv
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Run:
    run_dir: str
    name: str
    params: dict = field(default_factory=dict)
    metrics: list = field(default_factory=list)
    _t0: float = field(default_factory=time.time)

    def log_params(self, **kw) -> None:
        self.params.update({k: _jsonable(v) for k, v in kw.items()})
        self._flush_params()

    def log_metrics(self, step: int | float, **kw) -> None:
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 4)}
        rec.update({k: _jsonable(v) for k, v in kw.items()})
        self.metrics.append(rec)
        # append-flush so a crashed run keeps its trajectory on disk;
        # finish() still writes the tabular metrics.csv for audit
        with open(os.path.join(self.run_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec, default=_jsonable) + "\n")

    def log_artifact(self, name: str, obj: Any) -> str:
        path = os.path.join(self.run_dir, name)
        os.makedirs(os.path.dirname(path) or self.run_dir, exist_ok=True)
        with open(path, "w") as f:
            if name.endswith(".json"):
                json.dump(obj, f, indent=2, default=_jsonable)
            else:
                f.write(str(obj))
        return path

    def _flush_params(self):
        with open(os.path.join(self.run_dir, "params.json"), "w") as f:
            json.dump(self.params, f, indent=2)

    def finish(self) -> str:
        self._flush_params()
        mpath = os.path.join(self.run_dir, "metrics.csv")
        if self.metrics:
            keys = sorted({k for m in self.metrics for k in m})
            with open(mpath, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=keys)
                w.writeheader()
                w.writerows(self.metrics)
        with open(os.path.join(self.run_dir, "run.json"), "w") as f:
            json.dump({"name": self.name, "n_metrics": len(self.metrics),
                       "finished": time.strftime("%Y-%m-%dT%H:%M:%S")},
                      f, indent=2)
        return self.run_dir


@dataclass
class Tracker:
    root: str = "runs"

    def start_run(self, name: str) -> Run:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        base = os.path.join(self.root, f"{stamp}-{name}")
        # two runs in the same second must not share a directory: claim
        # the dir atomically, uniquifying with a numeric suffix on clash
        run_dir, i = base, 1
        while True:
            try:
                os.makedirs(run_dir)
                break
            except FileExistsError:
                run_dir = f"{base}-{i}"
                i += 1
        return Run(run_dir=run_dir, name=name)


def _jsonable(v):
    if hasattr(v, "item"):
        try:
            return v.item()
        except Exception:
            pass
    if isinstance(v, (dict, list, str, int, float, bool, type(None))):
        return v
    return str(v)
