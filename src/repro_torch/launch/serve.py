"""Serving driver of the PyTorch port — the closed loop of
``repro.launch.serve`` on one card, in its two modes.

``--mode classify`` (the default):
It trains the reference's classifier first, as ``repro.launch.serve``
does (``build_classifier``: a 3-layer, d 64 DistilBERT, vocab 600,
trained 150 steps of ``training.train_classifier`` on
``ClassificationData(vocab=600, seq_len=32, seed=1)``, on the card),
stands up ``repro_torch.serving.api.Server`` with the closed-loop
controller as admission middleware, replays that data's requests on the
chosen path with the proxy head after ``--exit-layer`` layers, and
prints the JSON summary.  The classifier is built from seed 0 whatever
``--seed`` says, as the reference's is, so ``--seed`` moves only the
arrivals.  ``--full-width`` serves the FULL-WIDTH DistilBERT instead (6
layers, d 768, 12 heads, vocab 30522; ``--layers`` cuts depth only,
``--seq-len`` sets the request length, 128 by default) with weights
drawn from ``--seed``, untrained.  ``--params PATH.npz`` loads a flat
reference checkpoint (as ``repro.training.checkpoint.save`` writes it)
into whichever of the two is chosen, and then nothing is trained.

    PYTHONPATH=src python -m repro_torch.launch.serve --path gated
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --controller bio --path auto --requests 400
    PYTHONPATH=src python -m repro_torch.launch.serve --full-width \
        --path gated --max-batch 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 32                     # plain-PyTorch path, no card

``--path auto`` precomputes an ``Oracle`` with the live engine (proxy
entropy through the CUDA kernel, full-model predictions), calibrates
latency models from measured walltimes and replays through the
virtual-time direct/dynamic-batch backend; ``--path gated`` runs the
live gated step, admission on the device.

``--mode generate``: continuous-batching decode of ``--arch`` (default
stablelm-3b) at its PUBLISHED width with weights from ``--seed``
(``--layers`` cuts depth only; ``--smoke`` takes the arch's reduced
smoke config, as the reference launcher always does), ``--slots`` decode
slots over a contiguous bf16 KV pool of 128 rows, the closed-loop
controller as admission middleware, and the reference's request stream:
16-token prompts from ``default_rng(seed)``, arrivals 1 ms apart, a
uniform entropy hint, ``--new-tokens`` each.  On the card, prefill runs
through the flash-attention kernel and every decode step through the
flash-decode kernel (``--attn-impl``).  ``--kv-block-size N`` serves
from a paged pool of ``N``-row blocks instead (``--kv-pool-blocks M``
blocks, trash block included; 0 sizes it for every slot's full
extent), whose decode steps run the paged flash-decode kernel; a
request waits in the queue while the pool cannot hold its budget.
``--arch mamba2-780m`` serves the attention-free SSD stack (48 layers,
d 1536, state 128 per head): its pool is the f32 recurrent state of
every slot, prefill runs the CUDA SSD scan kernel in every layer and a
decode step updates the state in place.  ``--arch granite-moe-3b-a800m``
serves the MoE family (32 layers, 24 query heads over 8 KV heads of 64,
40 experts of which each token takes 8, dropped past capacity as the
reference drops them), contiguous, paged or speculative;
``--arch minicpm3-4b`` the MLA family (62 layers, a 256 + 32-feature
latent per token in the pool, decoded in latent space in plain
PyTorch), contiguous; ``--arch recurrentgemma-2b`` the mixed stack (26
layers, two RG-LRU layers to each windowed-attention layer, window 2048,
10 query heads over 1 KV head of 256; the pool is a 2048-row ring per
attention layer and the f32 RG-LRU state per recurrent one),
contiguous; ``--arch paligemma-3b`` the prefix-LM's decoder (18
layers, 8 query heads over 1 KV head of 256) on text prompts,
contiguous, paged or speculative; ``--arch whisper-medium`` raises the
engine's error (the engine feeds no encoder input; the model API
serves it); ``--arch dbrx-132b`` (264 GB in bf16) only with
``--smoke``.  ``--temperature T`` (with
``--top-k`` and ``--top-p``) samples every token from the reference's
(seed, request, position)-folded threefry keys; ``--temperature 0`` (the
default) is greedy, byte for byte the argmax path.  ``--draft-depth D``
decodes self-speculatively: each window step drafts D tokens through
the first ``--draft-layers`` layers (0: ``n_layers - 1``) and verifies
them in one full-model chunk, the emitted tokens those of the
non-speculative path; the summary gains ``acceptance_rate``,
``accepted_per_step``, ``energy_per_token_model`` and
``draft_depth_live``.  On the card every decode window after a
session's first of its kind is the replay of one CUDA graph.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode generate
    PYTHONPATH=src python -m repro_torch.launch.serve --mode generate \
        --kv-block-size 16 --kv-pool-blocks 13
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --smoke --requests 8 --runs /tmp/runs
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --smoke --kv-block-size 8 --kv-pool-blocks 9
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --arch mamba2-780m --smoke --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --arch granite-moe-3b-a800m --smoke --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --arch minicpm3-4b --smoke --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --arch recurrentgemma-2b --smoke --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --arch paligemma-3b --smoke --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --arch paligemma-3b --smoke --kv-block-size 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --arch paligemma-3b --smoke --draft-depth 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --smoke --temperature 0.8 --top-k 50
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode generate --smoke --draft-depth 2

``--fleet`` serves through the multi-replica layer (``repro_torch.fleet``):
a heterogeneous replica pool (``--fleet-kinds``), a routing policy
(``--policy``), an optional autoscaler and a traffic scenario
(``--scenario``) — the ORT-vs-Triton boundary as a runtime decision.
The default replicas are the reference's oracle-backed virtual-time
nodes (host code only).  ``--fleet-live`` swaps them for LIVE replicas
over the classifier on the card (the trained default, or
``--full-width``): measured walltimes advance the virtual clock, and
every batch's proxy entropy runs the CUDA entropy kernel.  ``--chaos
NAME`` runs a named failure story (a scenario, a fault plan and a
deadline) with bounded retry and brownout.  ``--trace-out`` and
``--metrics-out`` write a Chrome trace and a metrics snapshot, and turn
on the energy-drift audit: modelled joules against ``--energy-source``
(``process``: process time; ``nvml``: the card's own energy counter).

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet
    PYTHONPATH=src python -m repro_torch.launch.serve --fleet-live \
        --requests 200 --max-batch 8 --trace-out /tmp/t.json \
        --metrics-out /tmp/m.json --energy-source nvml
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --fleet --chaos crash-storm --requests 200
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --fleet-live --requests 64 --runs /tmp/runs

``--fleet-disagg`` serves a generate scenario (``--scenario
prompt-burst``, the default, or ``long-decode``; 48 requests at 40 qps
by default) over the disaggregated fleet (``repro_torch.disagg``):
``--prefill-workers`` workers prefill each prompt at batch 1 through the
flash-attention kernel, the rows cross the modelled link, and
``--decode-workers`` workers insert them into their own sessions of
``--slots`` slots over 64 rows and decode them in the captured window,
all over one copy of ``generate_config(args)``'s weights (published
width, or ``--smoke``; ``--kv-block-size`` for paged pools).  It is
refused with ``--fleet`` and with a classify scenario, as the
reference's.  The summary adds each worker's busy seconds, the link's
transfers and bytes and each decode worker's window captures, which
stay off the virtual clock.

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet-disagg \
        --energy-source nvml --trace-out /tmp/t.json --metrics-out /tmp/m.json
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --fleet-disagg --smoke --kv-block-size 8 --runs /tmp/runs
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import (AdaptiveThreshold, AdmissionController,
                              CostWeights, DecayingThreshold, EnergyMeter,
                              EnergyModel, LatencyModel, energy_model_for)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.compile_cache import enable_compilation_cache
from repro_torch.models import distilbert
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import distilbert_from_numpy, load_flat_npz
from repro_torch.serving.adapters import (ContinuousEngineAdapter,
                                          GatedEngineAdapter, OracleEngine)
from repro_torch.serving.api import (PATH_CONTINUOUS, PATH_GATED,
                                     AdmissionMiddleware, InferRequest,
                                     Server, ServerConfig,
                                     TelemetryMiddleware, canonical_path)
from repro_torch.serving.batcher import DirectPath, DynamicBatcher
from repro_torch.serving.continuous import (ContinuousBatchingEngine,
                                            GenRequest, pool_hbm_bytes)
from repro_torch.serving.engine import ClassifierEngine
from repro_torch.serving.simulator import Oracle
from repro_torch.serving.workload import bursty_arrivals, poisson_arrivals
from repro_torch.telemetry import (NULL_METRICS, NULL_TRACER,
                                   CarbonTracker, CompileWatcher,
                                   EnergyDriftAudit, MetricsRegistry,
                                   Tracer, Tracker, export_observability,
                                   make_measured_source, validate_trace)
from repro_torch.training.data import ClassificationData
from repro_torch.training.train_loop import train_classifier


def device_energy_model(device: torch.device) -> EnergyModel:
    """The card's constant set (by name); the SXM default on the CPU."""
    if device.type == "cuda":
        return energy_model_for(torch.cuda.get_device_name(device))
    return EnergyModel()


def make_observability(args):
    """Tracer / metrics / drift-audit kit for one serving run.

    Real recorders only when ``--trace-out``/``--metrics-out`` asked
    for exports — the default stays the no-op fast path so untraced
    runs pay nothing.  The drift audit starts its measured-energy
    window immediately (``--energy-source``; ``nvml`` raises where the
    NVML library cannot be opened)."""
    if not (getattr(args, "trace_out", None)
            or getattr(args, "metrics_out", None)):
        return NULL_TRACER, NULL_METRICS, None
    audit = EnergyDriftAudit(
        source=make_measured_source(args.energy_source)).start()
    # build-time visibility: cuda.build / cuda.capture spans and the
    # compile_seconds gauge (0.0 when every library was opened as built)
    args._compile_watch = CompileWatcher().install()
    return Tracer(), MetricsRegistry(), audit


def finish_observability(args, run, tracer, metrics, audit, *,
                         modelled_j: float = 0.0,
                         n_requests: int = 0) -> dict:
    """Close the drift window, land artifacts beside the run's CSVs,
    and write the ``--trace-out``/``--metrics-out`` files.  Returns the
    drift report with the watcher's under ``compile`` (empty when
    observability is off)."""
    if audit is None:
        return {}
    audit.record(modelled_j, n_requests)
    report = audit.stop()
    if metrics.enabled:
        audit.export(metrics)
    watcher = getattr(args, "_compile_watch", None)
    if watcher is not None:
        report["compile"] = watcher.export(tracer, metrics)
    if run is not None:
        export_observability(run, tracer=tracer, metrics=metrics,
                             audit=audit)
    if getattr(args, "trace_out", None) and tracer.enabled:
        problems = validate_trace(tracer.spans)
        if problems:       # keep the artifact; the validator decides
            print("trace audit: " + "; ".join(problems[:5]),
                  file=sys.stderr)
        tracer.write_chrome(args.trace_out)
    if getattr(args, "metrics_out", None) and metrics.enabled:
        metrics.write_json(args.metrics_out)
        metrics.write_prometheus(
            os.path.splitext(args.metrics_out)[0] + ".prom")
    return report


# the reference's classify model (repro/launch/serve.py:125-132)
TRAINED_CFG = dict(n_layers=3, d_model=64, n_heads=4, d_ff=128, vocab=600,
                   max_pos=48)
TRAINED_SEQ_LEN = 32


def build_classifier(seed: int = 0, steps: int = 150, device="cuda"):
    """The reference's ``build_classifier``: the 3-layer, d 64
    DistilBERT drawn from ``seed`` and trained ``steps`` steps on
    ``device`` (the card by default; resolved before anything is
    built) -> (cfg, model, data, the trainer's log)."""
    dev = resolve_device(device)
    cfg = distilbert.config(**TRAINED_CFG)
    model = distilbert.init(cfg, seed=seed, device=dev)
    data = ClassificationData(vocab=cfg["vocab"], seq_len=TRAINED_SEQ_LEN,
                              seed=seed + 1)
    model, log = train_classifier(model, data.train_batches(32),
                                  steps=steps, verbose=False, device=dev)
    return cfg, model, data, log


def classify_model(args, device: torch.device):
    """The served classifier and its request data -> (cfg, model, data):
    ``build_classifier()`` by default; the full-width model with
    ``--full-width``; ``--params`` loaded into either, untrained."""
    if not args.full_width and (args.layers is not None
                                or args.seq_len is not None):
        raise ValueError("--layers and --seq-len size the --full-width "
                         "model; the trained classifier is the "
                         "reference's")
    if args.full_width:
        cfg = distilbert.config(
            n_layers=6 if args.layers is None else args.layers)
        seq_len, seed = args.seq_len or 128, args.seed
    elif not args.params:
        return build_classifier(device=device)[:3]
    else:
        cfg, seq_len, seed = (distilbert.config(**TRAINED_CFG),
                              TRAINED_SEQ_LEN, 0)
    if args.params:
        model = distilbert_from_numpy(cfg, load_flat_npz(args.params),
                                      device=device)
    else:
        model = distilbert.init(cfg, seed=seed, device=device)
    data = ClassificationData(vocab=cfg["vocab"], seq_len=seq_len,
                              seed=seed + 1)
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


def arrival_rate(args) -> float:
    """``--qps``, else the reference's defaults: 40 for a fleet (small
    sim fleets saturate at the single-server rate), 150 otherwise."""
    if args.qps is not None:
        return args.qps
    fleet = (args.fleet or args.fleet_live or args.chaos
             or args.fleet_disagg)
    return 40.0 if fleet else 150.0


def _arrivals(args, labels, payloads=None):
    qps = arrival_rate(args)
    if args.traffic == "bursty":
        return bursty_arrivals(args.requests, qps, qps * 8,
                               seed=args.seed, payloads=payloads,
                               labels=labels)
    return poisson_arrivals(args.requests, qps, seed=args.seed,
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

    cfg, model, data = classify_model(args, device)
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

    tracer, metrics, audit = make_observability(args)
    telem = TelemetryMiddleware(run=run)
    server = Server(port, ServerConfig(path=path, energy_model=em),
                    middleware=[AdmissionMiddleware(ctrl), telem],
                    tracer=tracer, metrics=metrics)
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
    drift = finish_observability(args, run, tracer, metrics, audit,
                                 modelled_j=server.energy_j,
                                 n_requests=args.requests)
    if drift:
        summary["energy_drift_ratio"] = drift["drift_ratio"]

    run.log_params(**vars(args))
    run.log_metrics(0, **{k: v for k, v in summary.items()
                          if isinstance(v, (int, float))})
    run.log_artifact("summary.json", summary)
    run.log_artifact("carbon.json", carbon.report())
    run.finish()
    return summary, server


def serve_fleet(args, classifier=None):
    """Run a traffic scenario (or a ``--chaos`` failure story) over a
    heterogeneous replica fleet — the reference's oracle-backed
    virtual-time replicas by default, the LIVE classifier on the device
    with ``--fleet-live``: the reference's trained classifier from
    ``--seed`` (``--full-width``: the seeded full-width DistilBERT), or
    ``classifier``, a ready ``(cfg, model, data)``, served as it is.
    -> (the printed summary, the ``FleetReport``, the ``ReplicaPool``)."""
    from repro_torch.faults import (BrownoutController, FaultInjector,
                                    RetryPolicy, make_chaos)
    from repro_torch.fleet import (LIVE_REPLICA_KINDS, REPLICA_KINDS,
                                   Autoscaler, FleetSimulator,
                                   build_live_fleet, build_sim_fleet,
                                   make_router, make_scenario,
                                   with_deadline, with_payloads)

    device = resolve_device(args.device)
    em = device_energy_model(device)
    kinds = tuple(k.strip() for k in args.fleet_kinds.split(","))
    valid = LIVE_REPLICA_KINDS if args.fleet_live else REPLICA_KINDS
    for k in kinds:
        if k not in valid:
            raise SystemExit(f"unknown replica kind {k!r}; choose from "
                             f"{valid}")
    qps = arrival_rate(args)

    chaos = None
    deadline = args.deadline
    if args.chaos:
        # a named failure story: its traffic trace + fault plan +
        # default deadline, reproducible per --chaos-seed
        chaos = make_chaos(args.chaos, args.requests, qps=qps,
                           seed=(args.seed if args.chaos_seed is None
                                 else args.chaos_seed))
        scenario = chaos.scenario
        if deadline is None:
            deadline = chaos.deadline_s
    else:
        scenario = make_scenario(args.scenario, args.requests, qps=qps,
                                 seed=args.seed)
    if deadline is not None:
        scenario = with_deadline(scenario, deadline)

    def controllers(kind, i):
        # each replica gets its OWN closed-loop controller
        return make_controller(args.controller, weights=args.weights,
                               target_rate=args.target_rate,
                               energy_model=em)

    extra = {}
    if args.fleet_live:
        if classifier is not None:
            cfg, model, data = classifier
        elif args.full_width or args.params:
            cfg, model, data = classify_model(args, device)
        else:
            cfg, model, data = build_classifier(seed=args.seed,
                                                device=device)[:3]
        toks, labels, _ = data.sample(args.requests)
        scenario = with_payloads(scenario, toks, labels=labels)
        pool = build_live_fleet(cfg, model, kinds=kinds,
                                controller_factory=controllers,
                                max_batch=args.max_batch,
                                queue_window_s=args.window,
                                exit_layer=args.exit_layer,
                                seq_len=toks.shape[1], energy_model=em,
                                device=device)
        extra = {"n_layers": cfg["n_layers"], "d_model": cfg["d_model"]}
    else:
        pool = build_sim_fleet(scenario.oracle, kinds=kinds,
                               controller_factory=controllers,
                               max_batch=args.max_batch,
                               queue_window_s=args.window,
                               n_slots=args.slots, energy_model=em)
    carbon = CarbonTracker(region=args.region,
                           meter=EnergyMeter(model=em))
    tracer, metrics, audit = make_observability(args)
    sim = FleetSimulator(
        pool, make_router(args.policy),
        autoscaler=Autoscaler() if args.autoscale else None,
        carbon=carbon, tracer=tracer, metrics=metrics,
        injector=(FaultInjector(chaos.plan) if chaos else None),
        retry_policy=(RetryPolicy() if chaos else None),
        brownout=(BrownoutController() if chaos else None))
    report = sim.run(scenario.requests)

    tracker = Tracker(root=args.runs)
    mode = "fleet-live" if args.fleet_live else "fleet"
    tag = f"chaos-{chaos.name}" if chaos else scenario.name
    run = tracker.start_run(f"torch-{mode}-{tag}-{args.policy}")
    drift = finish_observability(
        args, run, tracer, metrics, audit,
        modelled_j=float(report.summary.get("energy_j", 0.0)),
        n_requests=int(report.summary.get("n", args.requests)))
    if drift:
        report.summary["energy_drift_ratio"] = drift["drift_ratio"]
    run.log_params(**{k: str(v) for k, v in vars(args).items()})
    run.log_metrics(0, **{k: v for k, v in report.summary.items()
                          if isinstance(v, (int, float))})
    run.log_artifact("fleet_summary.json", report.summary)
    run.log_artifact("fleet_replicas.json", report.per_replica)
    run.log_artifact("carbon.json", report.carbon)
    if report.autoscaler_log:
        run.log_artifact("autoscaler.json", report.autoscaler_log)
    run.finish()

    out = {"scenario": scenario.name,
           "description": scenario.description,
           "policy": args.policy,
           "live": bool(args.fleet_live),
           "autoscale": bool(args.autoscale),
           **({"chaos": chaos.name,
               "fault_plan": chaos.plan.signature(),
               "deadline_s": deadline} if chaos else {}),
           **report.summary,
           "per_replica": report.per_replica,
           "autoscaler_actions": len(report.autoscaler_log),
           "carbon": report.carbon,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           **extra,
           **({"energy_drift": drift} if drift else {})}
    return out, report, pool


GEN_MAX_SEQ = 128      # the reference launcher's decode pool extent
GEN_PROMPT_LEN = 16
# the session's stats carried into the summary (the paged ones when paged,
# the speculative ones when speculative: ref launch/serve.py:446-458)
DECODE_STATS = ("mode", "decode_steps", "occupancy", "host_syncs",
                "prefill_calls", "device_s", "prefill_s", "window",
                "window_issue_s", "window_sync_s", "harvest_s", "caller_s",
                "capture_s", "captures", "pool_blocks",
                "blocks_allocated", "blocks_freed", "peak_blocks_in_use",
                "free_blocks", "draft_layers", "spec_proposed",
                "spec_accepted", "acceptance_rate", "accepted_per_step",
                "energy_per_token_model", "draft_depth_live")


def generate_config(args):
    """``--arch`` at published width (``--smoke``: its smoke config),
    depth cut by ``--layers``, attention dispatch ``--attn-impl``, the
    KV layout ``--kv-block-size`` / ``--kv-pool-blocks``, the engine's
    sampling defaults ``--temperature`` / ``--top-k`` / ``--top-p`` and
    the draft prefix ``--draft-layers``, which ``--draft-depth`` > 0
    with ``--draft-layers 0`` resolves to ``n_layers - 1`` (the
    reference's ``_apply_sampling_cfg``)."""
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.replace(attn_impl=args.attn_impl,
                      kv_block_size=args.kv_block_size,
                      kv_pool_blocks=args.kv_pool_blocks,
                      temperature=args.temperature,
                      sample_top_k=args.top_k, sample_top_p=args.top_p)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    draft_layers = args.draft_layers
    if args.draft_depth > 0 and draft_layers == 0:
        # auto: the deepest shallow-exit prefix the stack allows
        draft_layers = max(cfg.n_layers - 1, 1)
    return cfg.replace(draft_layers=draft_layers)


def serve_generate(args):
    """Serve one generate run; -> (summary dict, the finished ``Server``)."""
    device = resolve_device(args.device)
    em = device_energy_model(device)
    cfg = generate_config(args)
    model = tfm.init_lm(cfg, args.seed, device=device)
    engine = ContinuousBatchingEngine(cfg, model, n_slots=args.slots,
                                     max_seq=GEN_MAX_SEQ, device=device,
                                     draft_depth=args.draft_depth)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, size=(args.requests,
                                               GEN_PROMPT_LEN)
                           ).astype(np.int32)
    # untimed, at the served shapes: the kernels' build and every
    # first-call cost stay out of the measured windows
    engine.serve([GenRequest(rid=-1 - i, prompt=prompts[i % len(prompts)],
                             max_new=2)
                  for i in range(min(args.slots, len(prompts)))],
                 prompt_len=GEN_PROMPT_LEN)
    ctrl = make_controller(args.controller, weights=args.weights,
                           target_rate=args.target_rate, energy_model=em)
    tracer, metrics, audit = make_observability(args)
    server = Server(ContinuousEngineAdapter(engine,
                                            prompt_len=GEN_PROMPT_LEN),
                    ServerConfig(path=PATH_CONTINUOUS, energy_model=em),
                    middleware=[AdmissionMiddleware(ctrl)],
                    tracer=tracer, metrics=metrics)
    reqs = [InferRequest(rid=i, arrival_s=0.001 * i, payload=prompts[i],
                         kind="generate", max_new=args.new_tokens,
                         entropy_hint=float(rng.uniform(0, 1)))
            for i in range(args.requests)]
    responses = server.serve(reqs)
    summary = server.summary()
    drift = finish_observability(args, None, tracer, metrics, audit,
                                 modelled_j=server.energy_j,
                                 n_requests=args.requests)
    if drift:
        summary["energy_drift_ratio"] = drift["drift_ratio"]
    summary.pop("accuracy", None)     # no labels in generation mode
    decode_stats = {}
    for r in reversed(responses):
        if "decode_steps" in r.telemetry:
            decode_stats = {k: r.telemetry[k]
                            for k in DECODE_STATS if k in r.telemetry}
            break
    lat = np.array([r.latency_s for r in responses])
    summary.update(
        arch=cfg.arch_id, path=PATH_CONTINUOUS, controller=args.controller,
        attn_impl=args.attn_impl, kv_block_size=cfg.kv_block_size,
        kv_pool_bytes=pool_hbm_bytes(cfg, args.slots,
                                     GEN_MAX_SEQ)["total_bytes"],
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"),
        n_layers=cfg.n_layers, d_model=cfg.d_model, slots=args.slots,
        temperature=args.temperature, draft_depth=args.draft_depth,
        tokens_generated=sum(len(r.output) for r in responses
                             if isinstance(r.output, list)),
        p50_latency_ms=float(np.percentile(lat, 50)) * 1e3,
        p95_latency_ms=float(np.percentile(lat, 95)) * 1e3,
        sample=(responses[0].output[:8] if responses else []),
        **decode_stats)
    return summary, server


DISAGG_MAX_SEQ = 64    # the reference launcher's disaggregated pool extent


def build_disagg(args):
    """The ``--fleet-disagg`` fleet, built and warmed (its prefill
    engine and every decode worker's session set up, untimed) but not
    yet run.  The model is ``generate_config(args)``: ``--arch`` at
    published width, or ``--smoke``.  -> (the scenario, the
    ``DisaggPool``)."""
    from repro_torch.disagg import build_disagg_fleet
    from repro_torch.fleet import make_generate_scenario

    device = resolve_device(args.device)
    cfg = generate_config(args)
    params = tfm.init_lm(cfg, args.seed, device=device)
    scenario = make_generate_scenario(args.scenario, args.requests,
                                      qps=arrival_rate(args),
                                      seed=args.seed, vocab=cfg.vocab)
    pool = build_disagg_fleet(cfg, params,
                              n_prefill=args.prefill_workers,
                              n_decode=args.decode_workers,
                              n_slots=args.slots, max_seq=DISAGG_MAX_SEQ,
                              draft_depth=args.draft_depth,
                              energy_model=device_energy_model(device),
                              device=device)
    return scenario, pool


def serve_disagg(args, built=None):
    """``--fleet-disagg``: a generate scenario over the disaggregated
    prefill/decode fleet — separate phase pools over one copy of the
    LM's weights on the device, phase-aware routing, an autoscaler per
    phase.  ``built`` is ``build_disagg(args)``'s result, made here when
    not given.  -> (the printed summary, the ``DisaggReport``, the
    ``DisaggPool``)."""
    from repro_torch.disagg import DisaggSimulator, PhaseAwareRouter
    from repro_torch.fleet import Autoscaler

    scenario, pool = built or build_disagg(args)
    cfg = pool.prefill_workers[0].engine.cfg
    device = pool.prefill_workers[0].engine.device
    tracer, metrics, audit = make_observability(args)
    sim = DisaggSimulator(
        pool, router=PhaseAwareRouter(),
        prefill_scaler=Autoscaler() if args.autoscale else None,
        decode_scaler=Autoscaler() if args.autoscale else None,
        tracer=tracer, metrics=metrics)
    report = sim.run(scenario.requests)

    tracker = Tracker(root=args.runs)
    run = tracker.start_run(f"torch-fleet-disagg-{scenario.name}")
    drift = finish_observability(
        args, run, tracer, metrics, audit,
        modelled_j=float(report.summary.get("energy_j", 0.0)),
        n_requests=int(report.summary.get("n", args.requests)))
    if drift:
        report.summary["energy_drift_ratio"] = drift["drift_ratio"]
    run.log_params(**{k: str(v) for k, v in vars(args).items()})
    run.log_metrics(0, **{k: v for k, v in report.summary.items()
                          if isinstance(v, (int, float))})
    run.log_artifact("disagg_summary.json", report.summary)
    run.log_artifact("disagg_workers.json", report.per_worker)
    run.finish()

    out = {"scenario": scenario.name,
           "description": scenario.description,
           **report.summary,
           "per_worker": report.per_worker,
           "transfer": report.transfer,
           "autoscaler_actions": {
               k: len(v) for k, v in report.autoscaler_log.items()},
           # each decode session's window captures, off the clock
           "captures": {w.name: {"captures": w.captures,
                                 "capture_s": w.capture_s}
                        for w in pool.decode_workers},
           "arch": cfg.arch_id, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "kv_block_size": cfg.kv_block_size,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           **({"energy_drift": drift} if drift else {})}
    return out, report, pool


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--mode", choices=["classify", "generate"],
                    default="classify")
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="stablelm-3b",
                    help="generate mode: the decoder LM")
    ap.add_argument("--smoke", action="store_true",
                    help="generate mode: the arch's reduced smoke config "
                         "instead of its published width")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--attn-impl", choices=["auto", "xla", "ref", "cuda"],
                    default="auto",
                    help="generate mode: attention dispatch, and the SSD "
                         "scan's on an SSD stack ('auto': the CUDA kernels "
                         "on the card, the model's own path on the CPU; "
                         "'xla': the model's own path (einsum attention, "
                         "chunked SSD); 'ref': the kernels' plain versions; "
                         "'cuda': the kernels or raise)")
    ap.add_argument("--kv-block-size", type=int, default=0,
                    help="generate mode: paged KV pool block size in "
                         "rows (0 = contiguous per-slot cache)")
    ap.add_argument("--kv-pool-blocks", type=int, default=0,
                    help="generate mode: blocks in the paged pool, the "
                         "trash block included (0 = every slot's full "
                         "extent)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="generate mode: sampling temperature (0 = "
                         "greedy argmax, byte-identical to the default "
                         "path)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="generate mode: keep only the k highest "
                         "logits before sampling (0 = no cap)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="generate mode: nucleus sampling mass "
                         "(1.0 = no cap)")
    ap.add_argument("--draft-depth", type=int, default=0,
                    help="generate mode: self-speculative decode — "
                         "draft up to this many tokens per step with "
                         "a shallow prefix of the model, verify them in "
                         "one full-model pass (0 = off)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="layers in the shallow-exit draft prefix "
                         "(0 = auto n_layers-1 when --draft-depth>0)")
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
    ap.add_argument("--full-width", action="store_true",
                    help="classify mode: serve the full-width DistilBERT "
                         "(6 layers, d 768, seeded from --seed, untrained) "
                         "instead of the trained 3-layer, d 64 classifier")
    ap.add_argument("--params", default=None, metavar="PATH.npz",
                    help="classify mode: flat reference checkpoint "
                         "(repro.training.checkpoint.save) loaded into "
                         "the chosen model, which is then not trained")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (width stays full); default: 6 encoder "
                         "layers with --full-width, the arch's own depth "
                         "in generate mode")
    ap.add_argument("--exit-layer", type=int, default=1,
                    help="layers under the early-exit proxy head")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="--full-width: request length (default 128)")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--qps", type=float, default=None,
                    help="arrival rate (default: 150 single-server, "
                         "40 fleet — small sim fleets saturate at the "
                         "single-server default)")
    ap.add_argument("--traffic", choices=["poisson", "bursty"],
                    default="poisson")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--window", type=float, default=0.01)
    ap.add_argument("--region", default="world_avg")
    # observability (telemetry.trace / .metrics / .drift / .compile_watch)
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON (load it at "
                         "https://ui.perfetto.dev) covering every "
                         "request's triage/queue/execute spans; "
                         "enables tracing for the run")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry snapshot (JSON) "
                         "plus a Prometheus text sibling (.prom); "
                         "enables metrics for the run")
    ap.add_argument("--energy-source", default="process",
                    choices=["process", "nvml", "tpu"],
                    help="measured-energy reader for the drift audit "
                         "(modelled vs measured joules): 'process' is "
                         "process time x 200 W, 'nvml' the card's own "
                         "energy counter (raises without NVIDIA's "
                         "NVML library), 'tpu' raises as the "
                         "reference's does")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="directory the CUDA kernel libraries are built "
                         "into and found in (default "
                         "build/torch_kernels at the checkout's root)")
    ap.add_argument("--runs", default="runs")
    ap.add_argument("--seed", type=int, default=0)
    # fleet mode
    ap.add_argument("--fleet", action="store_true",
                    help="serve through the multi-replica fleet layer "
                         "(oracle-backed virtual-time replicas)")
    ap.add_argument("--fleet-live", action="store_true",
                    help="fleet over LIVE replicas (the classifier on "
                         "--device, measured walltimes); implies --fleet "
                         "(kinds limited to the classifier paths)")
    ap.add_argument("--fleet-disagg", action="store_true",
                    help="generate scenario over the disaggregated "
                         "prefill/decode fleet (separate phase pools, "
                         "phase-aware routing, an autoscaler per "
                         "phase); scenarios limited to the generate "
                         "pair (prompt-burst, long-decode)")
    ap.add_argument("--prefill-workers", type=int, default=2)
    ap.add_argument("--decode-workers", type=int, default=2)
    ap.add_argument("--scenario", default="flash-crowd",
                    choices=["steady", "flash-crowd", "diurnal",
                             "multi-tenant", "low-confidence-flood",
                             "prompt-burst", "long-decode"])
    ap.add_argument("--policy", default="energy-aware",
                    choices=["energy-aware", "round-robin",
                             "least-loaded", "static"])
    ap.add_argument("--fleet-kinds",
                    default="direct,dynamic-batch,gated-in-graph",
                    help="comma-separated replica kinds (>=1)")
    ap.add_argument("--no-autoscale", dest="autoscale",
                    action="store_false", default=True)
    # failure model (faults)
    ap.add_argument("--chaos", default=None,
                    help="named fault-injection story over the fleet "
                         "(crash-storm, slow-node, kv-pressure, "
                         "link-flap, crash-and-flap, seeded-storm): "
                         "scripted/seeded crashes, degradations and "
                         "link outages with bounded retry + brownout; "
                         "implies --fleet")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="seed for the chaos traffic trace and any "
                         "seeded fault schedule (default: --seed)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request completion deadline in seconds; "
                         "queued work past it is shed as a rejection-"
                         "with-reason (default: the chaos scenario's "
                         "deadline, or none)")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.compile_cache is not None:
        print(f"kernel library cache: "
              f"{enable_compilation_cache(args.compile_cache)}",
              file=sys.stderr)
    if args.chaos or args.fleet_live:
        args.fleet = True
    if args.fleet_disagg:
        # the reference's checks (repro/launch/serve.py:614-630)
        if args.fleet:
            raise SystemExit("--fleet-disagg and --fleet are separate "
                             "layers; pick one")
        if args.scenario not in ("prompt-burst", "long-decode"):
            if args.scenario == ap.get_default("scenario"):
                args.scenario = "prompt-burst"
            else:
                raise SystemExit(
                    f"--fleet-disagg serves generate traffic; "
                    f"--scenario must be prompt-burst or long-decode, "
                    f"not {args.scenario!r}")
        if args.requests == ap.get_default("requests"):
            args.requests = 48        # generate requests are heavy
        serve = serve_disagg
    elif args.fleet:
        # refuse single-server flags that fleet mode would silently
        # ignore (misleading experiment configs otherwise)
        ignored = [f"--{k} {getattr(args, k)}"
                   for k in ("mode", "path", "traffic")
                   if getattr(args, k) != ap.get_default(k)]
        if ignored:
            raise SystemExit(
                f"--fleet does not use {', '.join(ignored)}; fleet "
                f"traffic comes from --scenario and replicas from "
                f"--fleet-kinds")
        serve = serve_fleet
    elif args.mode == "generate":
        serve = serve_generate
    else:
        serve = serve_classifier
    summary = serve(args)[0]
    print(json.dumps(summary, indent=2, default=str))


if __name__ == "__main__":
    main()
