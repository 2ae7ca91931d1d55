"""``ClassificationData`` of ``repro.training.data``: the SST-2 stand-in
the classify path serves (no external datasets).

Two classes, each example built from class-conditioned token
distributions with a per-example **difficulty** knob.  Difficulty
controls class separability, so model confidence/entropy varies across
examples the way it does on real data — exactly the variance the
controller's L(x) exploits.  Same seed, same tokens as the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ClassificationData:
    """Two-class token-sequence task with per-example difficulty."""
    vocab: int = 1000
    seq_len: int = 64
    n_class_tokens: int = 50         # class-marker vocabulary slice
    seed: int = 0

    def sample(self, n: int, *, difficulty: np.ndarray | None = None):
        """-> (tokens [n, S], labels [n], difficulty [n]).

        difficulty d in [0,1]: fraction of positions drawn from noise
        instead of the class-conditional distribution.  d ~ U(0.2,0.95)
        by default, giving a broad entropy spectrum.
        """
        rng = np.random.default_rng(self.seed)
        labels = rng.integers(0, 2, size=n)
        if difficulty is None:
            difficulty = rng.uniform(0.2, 0.95, size=n)
        toks = rng.integers(self.n_class_tokens * 2, self.vocab,
                            size=(n, self.seq_len))
        for i in range(n):
            # class tokens live in [label*K, (label+1)*K)
            k = self.n_class_tokens
            cls_toks = rng.integers(labels[i] * k, (labels[i] + 1) * k,
                                    size=self.seq_len)
            keep = rng.random(self.seq_len) >= difficulty[i]
            toks[i] = np.where(keep, cls_toks, toks[i])
        return toks.astype(np.int32), labels.astype(np.int32), difficulty
