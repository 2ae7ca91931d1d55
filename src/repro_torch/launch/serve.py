"""Classify serving driver of the PyTorch port — the closed loop of
``repro.launch.serve --mode classify`` on one card.

It builds the FULL-WIDTH DistilBERT (6 layers, d 768, 12 heads, vocab
30522; ``--layers`` cuts depth only) from a flat reference checkpoint
(``--params PATH.npz``, as ``repro.training.checkpoint.save`` writes
it) or from a seeded ``torch.Generator``, stands up
``repro_torch.serving.api.Server`` with the closed-loop controller as
admission middleware, replays ``ClassificationData(vocab=30522,
seq_len=128)`` requests on the chosen path, and prints the JSON
summary.  The port only serves: it trains nothing.

    PYTHONPATH=src python -m repro_torch.launch.serve --path gated
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --controller bio --path auto --requests 400
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --layers 1 --requests 32          # plain-PyTorch path, no card

``--path auto`` precomputes an ``Oracle`` with the live engine (proxy
entropy through the CUDA kernel, full-model predictions), calibrates
latency models from measured walltimes and replays through the
virtual-time direct/dynamic-batch backend; ``--path gated`` runs the
live gated step, admission on the device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core import (AdaptiveThreshold, AdmissionController,
                              CostWeights, DecayingThreshold, EnergyMeter,
                              EnergyModel, LatencyModel, energy_model_for)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import distilbert
from repro_torch.models.convert import distilbert_from_numpy, load_flat_npz
from repro_torch.serving.adapters import (GatedEngineAdapter, OracleEngine)
from repro_torch.serving.api import (PATH_GATED, AdmissionMiddleware, Server,
                                     ServerConfig, TelemetryMiddleware,
                                     canonical_path)
from repro_torch.serving.batcher import DirectPath, DynamicBatcher
from repro_torch.serving.engine import ClassifierEngine
from repro_torch.serving.simulator import Oracle
from repro_torch.serving.workload import bursty_arrivals, poisson_arrivals
from repro_torch.telemetry.carbon import CarbonTracker
from repro_torch.telemetry.tracker import Tracker
from repro_torch.training.data import ClassificationData


def device_energy_model(device: torch.device) -> EnergyModel:
    """The card's constant set (by name); the SXM default on the CPU."""
    if device.type == "cuda":
        return energy_model_for(torch.cuda.get_device_name(device))
    return EnergyModel()


def build_classifier(args, device: torch.device):
    """Full-width DistilBERT (depth ``--layers``) + the request data."""
    cfg = distilbert.config(n_layers=args.layers)
    if args.params:
        model = distilbert_from_numpy(cfg, load_flat_npz(args.params),
                                      device=device)
    else:
        model = distilbert.init(cfg, seed=args.seed, device=device)
    data = ClassificationData(vocab=cfg["vocab"], seq_len=args.seq_len,
                              seed=args.seed + 1)
    return cfg, model, data


def make_controller(kind: str, *, weights: str, target_rate: float,
                    energy_model: EnergyModel):
    w = {"balanced": CostWeights(),
         "performance": CostWeights.performance_priority(),
         "ecology": CostWeights.ecology_priority()}[weights]
    meter = EnergyMeter(model=energy_model)
    if kind == "open":
        return AdmissionController(enabled=False, meter=meter)
    if kind == "adaptive":
        th = AdaptiveThreshold(base=DecayingThreshold(0.9, 0.4, 0.5),
                               target_rate=target_rate)
    else:
        th = DecayingThreshold(tau0=1.0, tau_inf=0.45, k=0.8)
    ctrl = AdmissionController(threshold=th, meter=meter)
    ctrl.cost.weights = w
    return ctrl


def _arrivals(args, labels, payloads=None):
    if args.traffic == "bursty":
        return bursty_arrivals(args.requests, args.qps, args.qps * 8,
                               seed=args.seed, payloads=payloads,
                               labels=labels)
    return poisson_arrivals(args.requests, args.qps, seed=args.seed,
                            payloads=payloads, labels=labels)


def serve_classifier(args):
    """Serve one run; -> (summary dict, the finished ``Server``)."""
    device = resolve_device(args.device)
    em = device_energy_model(device)
    tracker = Tracker(root=args.runs)
    run = tracker.start_run(f"serve-torch-{args.controller}-{args.path}")
    carbon = CarbonTracker(region=args.region,
                           meter=EnergyMeter(model=em))
    path = canonical_path(args.path)

    cfg, model, data = build_classifier(args, device)
    toks, labels, _ = data.sample(args.requests)
    ctrl = make_controller(args.controller, weights=args.weights,
                           target_rate=args.target_rate, energy_model=em)
    extra = {}

    if path == PATH_GATED:
        # live admission on the device over the real model; the open
        # baseline lifts the gate's static capacity to the full batch
        cap = args.max_batch if args.controller == "open" else None
        port = GatedEngineAdapter(cfg, model, batch=args.max_batch,
                                  capacity=cap, exit_layer=args.exit_layer,
                                  device=device)
        reqs = _arrivals(args, labels, payloads=toks)
    else:
        # precompute the oracle (one batched pass — what carbon
        # measures here), calibrate latency models from measured
        # walltimes, then replay through the virtual-time backend
        engine = ClassifierEngine(cfg, model, exit_layer=args.exit_layer,
                                  device=device)
        # untimed, on the shapes timed below: the kernel build, the
        # context and each bucket's first-call costs stay out of t_proxy
        engine.proxy_scores(toks)
        engine.classify(toks)
        carbon.start()
        proxy_pred, entropy, _, t_proxy = engine.proxy_scores(toks)
        full_pred, t_full = engine.classify(toks)
        carbon.stop(args.requests)
        n_batches = -(-len(toks) // 128)
        extra = {"proxy_ms_per_batch": t_proxy / n_batches * 1e3,
                 "full_ms_per_batch": t_full / n_batches * 1e3}
        times = engine.calibrate(seq_len=toks.shape[1],
                                 buckets=(1, 4, 16))
        t1, t16 = times[1], times[16]
        t_tok = max((t16 - t1) / 15, 1e-5)
        direct_lat = LatencyModel(t_fixed_s=max(t1 - t_tok, 1e-4),
                                  t_tok_s=t_tok)
        batched_lat = LatencyModel(t_fixed_s=max(t1 - t_tok, 1e-4) * 6,
                                   t_tok_s=t_tok)
        oracle = Oracle(full_pred=full_pred, proxy_pred=proxy_pred,
                        entropy=entropy, labels=labels,
                        proxy_latency=LatencyModel(
                            t_proxy / len(toks), 0.0))
        port = OracleEngine(
            oracle, DirectPath(direct_lat),
            DynamicBatcher(batched_lat, max_batch_size=args.max_batch,
                           queue_window_s=args.window))
        reqs = _arrivals(args, labels)

    telem = TelemetryMiddleware(run=run)
    server = Server(port, ServerConfig(path=path, energy_model=em),
                    middleware=[AdmissionMiddleware(ctrl), telem])
    if path == PATH_GATED:
        carbon.start()
        server.serve(reqs)
        carbon.stop(args.requests)
        extra = {"step_ms_per_batch":
                 float(np.mean(port.batch_times)) * 1e3}
    else:
        server.serve(reqs)
    summary = server.summary()
    lat = np.array([r.latency_s for r in server.responses])
    summary.update(
        controller=args.controller, path=path,
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"),
        n_layers=cfg["n_layers"], d_model=cfg["d_model"],
        p50_latency_ms=float(np.percentile(lat, 50)) * 1e3, **extra)

    run.log_params(**vars(args))
    run.log_metrics(0, **{k: v for k, v in summary.items()
                          if isinstance(v, (int, float))})
    run.log_artifact("summary.json", summary)
    run.log_artifact("carbon.json", carbon.report())
    run.finish()
    return summary, server


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--path",
                    choices=["direct", "batched", "dynamic-batch",
                             "gated", "gated-in-graph", "auto"],
                    default="auto")
    ap.add_argument("--controller",
                    choices=["open", "bio", "adaptive"], default="bio")
    ap.add_argument("--weights",
                    choices=["balanced", "performance", "ecology"],
                    default="balanced")
    ap.add_argument("--target-rate", type=float, default=0.6)
    ap.add_argument("--params", default=None, metavar="PATH.npz",
                    help="flat reference checkpoint (repro.training."
                         "checkpoint.save); default: seeded init")
    ap.add_argument("--layers", type=int, default=6,
                    help="encoder depth (width stays full)")
    ap.add_argument("--exit-layer", type=int, default=1,
                    help="layers under the early-exit proxy head")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--qps", type=float, default=150.0)
    ap.add_argument("--traffic", choices=["poisson", "bursty"],
                    default="poisson")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--window", type=float, default=0.01)
    ap.add_argument("--region", default="world_avg")
    ap.add_argument("--runs", default="runs")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    summary, _ = serve_classifier(parser().parse_args(argv))
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
