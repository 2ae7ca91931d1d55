"""The closed-loop, energy-aware admission control (the paper's
contribution), ported from ``repro.core``.

Public surface:
  - CostModel / CostWeights        (Eq. 1: J = aL + bE + cC)
  - DecayingThreshold / AdaptiveThreshold   (Eq. 3: tau(t) decay)
  - AdmissionController / gate_batch        (Appendix A algorithm)
  - DraftDepthController                    (the live speculative depth)
  - EnergyModel / EnergyMeter / RooflineTerms (H100 constants)
  - CostLandscape / LatencyModel / OperatingState
"""
from repro_torch.core.controller import (AdmissionController, CongestionState,
                                         Decision, DraftDepthController,
                                         gate_batch)
from repro_torch.core.cost import CostModel, CostWeights, Normalizer
from repro_torch.core.energy import (H100_PCIE, H100_SXM, EnergyMeter,
                                     EnergyModel, RooflineTerms,
                                     energy_model_for)
from repro_torch.core.landscape import (CostLandscape, LatencyModel,
                                        OperatingState)
from repro_torch.core.threshold import AdaptiveThreshold, DecayingThreshold

__all__ = [
    "AdmissionController", "CongestionState", "Decision",
    "DraftDepthController", "gate_batch",
    "CostModel", "CostWeights", "Normalizer",
    "EnergyMeter", "EnergyModel", "RooflineTerms", "H100_SXM", "H100_PCIE",
    "energy_model_for",
    "CostLandscape", "LatencyModel", "OperatingState",
    "AdaptiveThreshold", "DecayingThreshold",
]
