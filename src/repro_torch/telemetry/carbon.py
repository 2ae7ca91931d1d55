"""Carbon accounting — the CodeCarbon analogue (paper §III-C).

Wraps an EnergyMeter window with grid-intensity conversion and emits
the per-run kWh / kgCO2 record the paper logs next to MLflow metrics.
Regional grid intensities are configurable (the paper's Threats to
Validity notes CO2 depends on the grid).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.energy import EnergyMeter, EnergyModel

GRID_INTENSITY_KG_PER_KWH = {
    "world_avg": 0.475,
    "us_avg": 0.38,
    "eu_avg": 0.28,
    "france": 0.06,
    "poland": 0.76,
    "tunisia": 0.47,          # the authors' locale
}


@dataclass
class CarbonTracker:
    """Per-run (or per-fleet-node) energy -> CO2 accounting.

    ``region`` picks a grid intensity from
    :data:`GRID_INTENSITY_KG_PER_KWH`; pass an explicit ``intensity``
    (kgCO2/kWh) instead when the node sits in a grid the table doesn't
    know — fleet replicas may span regions — in which case ``region``
    is treated as a free-form label.
    """
    region: str = "world_avg"
    intensity: float | None = None       # kgCO2/kWh override
    meter: EnergyMeter = field(default_factory=EnergyMeter)
    _start: float | None = field(default=None, init=False)

    def __post_init__(self):
        if self.intensity is None:
            if self.region not in GRID_INTENSITY_KG_PER_KWH:
                known = ", ".join(sorted(GRID_INTENSITY_KG_PER_KWH))
                raise ValueError(
                    f"unknown grid region {self.region!r}; known regions: "
                    f"{known} — or pass an explicit "
                    f"intensity=<kgCO2/kWh> override")
            self.intensity = GRID_INTENSITY_KG_PER_KWH[self.region]
        elif self.intensity < 0:
            raise ValueError(
                f"intensity must be >= 0 kgCO2/kWh, got {self.intensity}")

    def start(self) -> None:
        self._start = time.time()
        self.meter.start()

    def stop(self, n_requests: int = 1) -> dict:
        joules = self.meter.stop(n_requests)
        return self.report(joules=joules)

    def report(self, joules: float | None = None) -> dict:
        j = self.meter.total_joules if joules is None else joules
        kwh = EnergyModel.kwh(j)
        return {
            "energy_j": round(j, 3),
            "energy_kwh": round(kwh, 9),
            "co2_kg": round(kwh * self.intensity, 9),
            "region": self.region,
            "intensity_kg_per_kwh": self.intensity,
        }
