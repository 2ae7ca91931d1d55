"""Disaggregated (split-phase) LM serving — prefill/decode as
separate replica pools over one weight copy, ported from
``repro.disagg``.

Start at :class:`DisaggEngine` (the prefill -> insert -> generate
three-step API), :class:`DisaggEngineAdapter` (the ``EnginePort``
face the unified ``Server`` drives), and :class:`DisaggSimulator`
(the two-pool fleet with phase-aware routing, a modelled
``TransferQueue`` link, and an ``Autoscaler`` per phase).  On the
card a prefill's attention is the flash-attention kernel and a decode
worker's window the flash-decode (or paged flash-decode) kernel,
replayed as a CUDA graph."""
from repro_torch.disagg.adapter import DisaggEngineAdapter
from repro_torch.disagg.engine import (DisaggEngine, PrefillEngine,
                                       PrefillResult)
from repro_torch.disagg.fleet import (DecodeWorker, DisaggPool,
                                      DisaggReport, DisaggSimulator,
                                      PhaseAwareRouter, PhasePool,
                                      PrefillWorker, build_disagg_fleet)
from repro_torch.disagg.transfer import Transfer, TransferQueue

__all__ = [
    "DisaggEngine", "PrefillEngine", "PrefillResult",
    "DisaggEngineAdapter",
    "Transfer", "TransferQueue",
    "DecodeWorker", "DisaggPool", "DisaggReport", "DisaggSimulator",
    "PhaseAwareRouter", "PhasePool", "PrefillWorker",
    "build_disagg_fleet",
]
