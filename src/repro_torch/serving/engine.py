"""Model execution engine for classify serving, ported from
``repro.serving.engine``.

``ClassifierEngine`` — the ablation/dual-path workhorse: a DistilBERT
classifier with a cheap early-exit proxy head.  Calls are padded to
the reference's power-of-two buckets so both run the same shapes.  The
proxy head's entropy goes through ``kernels.ops.entropy_stats``: the
CUDA kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.runtime import resolve_device, synchronize
from repro_torch.models.distilbert import DistilBERT


def bucket_size(n: int, buckets=(1, 2, 4, 8, 16, 32, 64, 128)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class ClassifierEngine:
    cfg: dict
    params: DistilBERT
    exit_layer: int = 2
    entropy_impl: str = "auto"        # kernels.ops impl for the proxy L(x)
    device: str | torch.device = "cuda"

    step_times: dict = field(default_factory=dict, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = self.params.to(self.device).eval()

    @torch.inference_mode()
    def _proxy(self, tokens: torch.Tensor):
        lg = self.params.early_exit_logits(tokens,
                                           exit_layer=self.exit_layer)
        ent, maxp, amax = kops.entropy_stats(lg, impl=self.entropy_impl)
        return lg, ent, maxp, amax

    @torch.inference_mode()
    def _full(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.params.logits(tokens)

    def _pad(self, tokens: np.ndarray):
        n = tokens.shape[0]
        b = bucket_size(n)
        if b != n:
            tokens = np.concatenate(
                [tokens, np.zeros((b - n,) + tokens.shape[1:],
                                  tokens.dtype)], 0)
        return torch.from_numpy(np.ascontiguousarray(tokens)).to(
            self.device, torch.long), n

    def _chunks(self, tokens: np.ndarray, max_bucket: int = 128):
        for i in range(0, len(tokens), max_bucket):
            yield tokens[i:i + max_bucket]

    def proxy_scores(self, tokens: np.ndarray):
        """-> (proxy_pred [n], entropy [n], max_prob [n]) + walltime."""
        preds, ents, maxps, dt = [], [], [], 0.0
        for chunk in self._chunks(np.asarray(tokens)):
            x, n = self._pad(chunk)
            synchronize(self.device)
            t0 = time.perf_counter()
            lg, ent, maxp, amax = self._proxy(x)
            synchronize(self.device)
            dt += time.perf_counter() - t0
            preds.append(amax[:n].cpu().numpy())
            ents.append(ent[:n].cpu().numpy())
            maxps.append(maxp[:n].cpu().numpy())
        return (np.concatenate(preds), np.concatenate(ents),
                np.concatenate(maxps), dt)

    def classify(self, tokens: np.ndarray):
        """-> (pred [n], walltime_s) through the full model."""
        preds, dt = [], 0.0
        for chunk in self._chunks(np.asarray(tokens)):
            x, n = self._pad(chunk)
            synchronize(self.device)
            t0 = time.perf_counter()
            lg = self._full(x)
            synchronize(self.device)
            dt += time.perf_counter() - t0
            preds.append(lg[:n].argmax(-1).cpu().numpy())
        return np.concatenate(preds), dt

    def calibrate(self, seq_len: int, buckets=(1, 4, 16, 64),
                  iters: int = 3) -> dict:
        """Measure per-bucket step times (fills the latency model)."""
        for b in buckets:
            toks = np.zeros((b, seq_len), np.int32)
            self.classify(toks)                      # warm
            t0 = time.perf_counter()
            for _ in range(iters):
                self.classify(toks)
            self.step_times[b] = (time.perf_counter() - t0) / iters
        return dict(self.step_times)
