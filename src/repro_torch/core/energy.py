"""Energy accounting — the CodeCarbon + NVML analogue, for the H100.

Two signal sources feed the controller's E(x):

1. **Analytic model** (``EnergyModel``): joules derived from FLOP/byte
   counts via the roofline time estimate
       t = max(FLOPs/peak, bytes/hbm_bw, coll_bytes/link_bw)
       E = P_active * t + P_idle * wall
   using the constants of the card the port runs on.
2. **Measured EWMA** (``EnergyMeter``): rolling joules/request from
   observed walltimes — the live closed-loop signal, exactly the role
   CodeCarbon+NVML play in the paper.

Hardware constants come from NVIDIA's H100 Tensor Core GPU data sheet
(dense rates, i.e. without structured sparsity).  The SXM and PCIe
parts differ, so :func:`energy_model_for` picks the set from the name
``torch.cuda.get_device_name`` reports.  The data sheet gives no idle
power: ``P_IDLE_W`` is an ASSUMPTION, and ``chip_smoke.py`` prints the
card's measured idle ``power.draw`` beside it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

# --- NVIDIA H100 SXM5 80 GB (data sheet, dense) ----------------------------
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor core
HBM_BW = 3.35e12                # B/s, HBM3
NVLINK_BW = 900e9               # B/s, NVLink 4 total per card
P_ACTIVE_W = 700.0              # max thermal design power
P_IDLE_W = 70.0                 # ASSUMED: not in the data sheet

# --- NVIDIA H100 PCIe 80 GB (data sheet, dense) ----------------------------
PCIE_PEAK_FLOPS_BF16 = 756e12   # FLOP/s, bf16 tensor core
PCIE_HBM_BW = 2.0e12            # B/s, HBM2e
PCIE_NVLINK_BW = 600e9          # B/s, NVLink bridge
PCIE_P_ACTIVE_W = 350.0         # max thermal design power
PCIE_P_IDLE_W = 50.0            # ASSUMED: not in the data sheet

GRID_KG_CO2_PER_KWH = 0.4       # default grid carbon intensity


@dataclass(frozen=True)
class RooflineTerms:
    """The three §Roofline terms, in seconds (per step, per card)."""
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


@dataclass(frozen=True)
class EnergyModel:
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    link_bw: float = NVLINK_BW
    p_active: float = P_ACTIVE_W
    p_idle: float = P_IDLE_W

    def roofline(self, flops: float, bytes_: float, coll_bytes: float,
                 n_chips: int = 1) -> RooflineTerms:
        return RooflineTerms(
            compute_s=flops / (n_chips * self.peak_flops),
            memory_s=bytes_ / (n_chips * self.hbm_bw),
            collective_s=coll_bytes / (n_chips * self.link_bw))

    def joules(self, terms: RooflineTerms, n_chips: int = 1) -> float:
        """Modelled energy for one step across the cards."""
        t = terms.step_time_s
        return n_chips * (self.p_active * t)

    def joules_idle(self, wall_s: float, n_chips: int = 1) -> float:
        return n_chips * self.p_idle * wall_s

    @staticmethod
    def kwh(joules: float) -> float:
        return joules / 3.6e6

    @staticmethod
    def co2_kg(joules: float,
               grid=GRID_KG_CO2_PER_KWH) -> float:
        return EnergyModel.kwh(joules) * grid


H100_SXM = EnergyModel()
H100_PCIE = EnergyModel(peak_flops=PCIE_PEAK_FLOPS_BF16,
                        hbm_bw=PCIE_HBM_BW, link_bw=PCIE_NVLINK_BW,
                        p_active=PCIE_P_ACTIVE_W, p_idle=PCIE_P_IDLE_W)


def energy_model_for(device_name: str) -> EnergyModel:
    """The constant set for a card, by its CUDA device name: the PCIe
    part when the name says so ("NVIDIA H100 PCIe"), else the SXM part
    ("NVIDIA H100 80GB HBM3")."""
    return H100_PCIE if "pcie" in device_name.lower() else H100_SXM


@dataclass
class EnergyMeter:
    """Rolling joules/request EWMA — the controller's live E(x) signal.

    On real hardware the sample source is NVML/CodeCarbon; here each
    sample is (walltime x modelled power), or an explicit joules value
    from the analytic model during simulation.
    """
    model: EnergyModel = field(default_factory=EnergyModel)
    ewma: float = 0.2
    n_chips: int = 1

    _j_per_req: float = field(default=0.0, init=False)
    _total_j: float = field(default=0.0, init=False)
    _n: int = field(default=0, init=False)
    _t0: float | None = field(default=None, init=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_requests: int = 1) -> float:
        """Close a measurement window; returns joules for the window."""
        if self._t0 is None:
            raise RuntimeError("EnergyMeter.stop() before start()")
        wall = time.perf_counter() - self._t0
        self._t0 = None
        j = self.model.p_active * wall * self.n_chips
        self.record(j, n_requests)
        return j

    def record(self, joules: float, n_requests: int = 1) -> None:
        self._total_j += joules
        self._n += n_requests
        if n_requests <= 0:
            return          # energy burned but no request to pin it on:
                            # count the joules, leave the EWMA alone
        per = joules / n_requests
        if self._j_per_req == 0.0:
            self._j_per_req = per
        else:
            self._j_per_req = ((1 - self.ewma) * self._j_per_req
                               + self.ewma * per)

    @property
    def joules_per_request(self) -> float:
        return self._j_per_req

    @property
    def total_joules(self) -> float:
        return self._total_j

    @property
    def total_kwh(self) -> float:
        return EnergyModel.kwh(self._total_j)

    @property
    def total_co2_kg(self) -> float:
        return EnergyModel.co2_kg(self._total_j)
