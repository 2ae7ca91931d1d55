"""Classify and generate serving (engines, the gated step, continuous
batching, adapters, the ``Server`` API, the closed-loop simulator),
ported from ``repro.serving``.

Start at ``Server`` + an ``EnginePort`` adapter: one
``InferRequest``/``InferResponse`` lifecycle — enqueue, proxy triage,
admission middleware, routing, execution, per-request telemetry — over
the ``direct``, ``dynamic-batch``, ``gated-in-graph`` and
``continuous-decode`` paths.  ``ClosedLoopSimulator`` is the
reference's shim over the same ``Server``.
"""
from repro_torch.serving.adapters import (CallableEngineAdapter,
                                          ClassifierEngineAdapter,
                                          ContinuousEngineAdapter,
                                          GatedEngineAdapter, OracleEngine)
from repro_torch.serving.api import (ALL_PATHS, PATH_AUTO, PATH_CONTINUOUS,
                                     PATH_DIRECT, PATH_DYNAMIC_BATCH,
                                     PATH_GATED, PATH_GENERATE, PATH_SKIP,
                                     AdmissionMiddleware, Completion,
                                     EngineCapabilities, EnginePort,
                                     InferRequest, InferResponse, LoadState,
                                     Server, ServerConfig, ServingMiddleware,
                                     TelemetryMiddleware, TriageResult,
                                     canonical_path, engine_pressure,
                                     load_pressure)
from repro_torch.serving.batcher import (Batch, BatchQueue, DirectPath,
                                         DynamicBatcher, ServiceLine)
from repro_torch.serving.continuous import (ContinuousBatchingEngine,
                                            DecodeSession, GenRequest,
                                            SlotClock, blocks_for_request,
                                            pool_hbm_bytes)
from repro_torch.serving.engine import (ClassifierEngine, GenerationEngine,
                                        bucket_size)
from repro_torch.serving.gated import (GateParams, gate_admit,
                                       gate_objective,
                                       make_gated_classify_step, serve_gated)
from repro_torch.serving.simulator import (ClosedLoopSimulator, Oracle,
                                           ServedRecord, SimMetrics)
from repro_torch.serving.workload import (Request, bursty_arrivals,
                                          closed_loop_arrivals,
                                          nonhomogeneous_arrivals,
                                          poisson_arrivals)

__all__ = [
    # unified API
    "ALL_PATHS", "PATH_AUTO", "PATH_CONTINUOUS", "PATH_DIRECT",
    "PATH_DYNAMIC_BATCH", "PATH_GATED", "PATH_GENERATE", "PATH_SKIP",
    "AdmissionMiddleware", "Completion", "EngineCapabilities",
    "EnginePort", "InferRequest", "InferResponse", "LoadState",
    "Server", "ServerConfig", "ServingMiddleware", "TelemetryMiddleware",
    "TriageResult", "canonical_path", "engine_pressure", "load_pressure",
    # adapters
    "CallableEngineAdapter", "ClassifierEngineAdapter",
    "ContinuousEngineAdapter", "GatedEngineAdapter", "OracleEngine",
    # building blocks
    "Batch", "BatchQueue", "DirectPath", "DynamicBatcher", "ServiceLine",
    "ContinuousBatchingEngine", "DecodeSession", "GenRequest",
    "SlotClock", "blocks_for_request", "pool_hbm_bytes",
    "ClassifierEngine", "GenerationEngine", "bucket_size",
    "GateParams", "gate_admit", "gate_objective",
    "make_gated_classify_step", "serve_gated",
    "ClosedLoopSimulator", "Oracle", "ServedRecord", "SimMetrics",
    "Request", "bursty_arrivals", "closed_loop_arrivals",
    "nonhomogeneous_arrivals", "poisson_arrivals",
]
