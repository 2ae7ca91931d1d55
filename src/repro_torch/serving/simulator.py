"""The ``Oracle`` of ``repro.serving.simulator``: precomputed
per-request model behaviour, replayed by ``adapters.OracleEngine`` on
the direct and dynamic-batch paths (so request sweeps run in
milliseconds and every run is exactly reproducible)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.landscape import LatencyModel


@dataclass
class Oracle:
    """Per-request model behaviour, precomputed (index = request rid)."""
    full_pred: np.ndarray            # [N]
    proxy_pred: np.ndarray           # [N]
    entropy: np.ndarray              # [N] proxy softmax entropy (L(x))
    labels: np.ndarray | None = None
    proxy_latency: LatencyModel | None = None   # triage cost
