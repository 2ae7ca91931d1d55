"""Synthetic data of ``repro.training.data`` (no external datasets),
numpy only: the same seed gives the reference's arrays byte for byte.

``lm_batches`` — a deterministic-seed token stream with Zipfian unigram
statistics plus induced bigram structure, so language models have real
signal to fit (loss decreases measurably within a few hundred steps).

``ClassificationData`` — the SST-2 stand-in the classify path serves.
Two classes, each example built from class-conditioned token
distributions with a per-example **difficulty** knob.  Difficulty
controls class separability, so model confidence/entropy varies across
examples the way it does on real data — exactly the variance the
controller's L(x) exploits.  Same seed, same tokens as the reference,
``train_batches`` included.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def lm_batches(*, vocab: int, batch: int, seq_len: int, seed: int = 0,
               zipf_a: float = 1.2):
    """Infinite iterator of (tokens [B,S+1]) with bigram structure."""
    rng = np.random.default_rng(seed)
    # zipfian unigram over an effective vocab slice
    eff = min(vocab, 4096)
    ranks = np.arange(1, eff + 1, dtype=np.float64)
    p = ranks ** (-zipf_a)
    p /= p.sum()
    # deterministic "successor" table induces learnable bigrams
    succ = rng.permutation(eff)
    while True:
        base = rng.choice(eff, size=(batch, seq_len + 1), p=p)
        # half the positions follow the successor rule
        follow = rng.random((batch, seq_len)) < 0.5
        out = base.copy()
        for t in range(seq_len):
            out[:, t + 1] = np.where(follow[:, t], succ[out[:, t]],
                                     base[:, t + 1])
        yield out.astype(np.int32)


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

    def train_batches(self, batch: int, seed: int | None = None):
        """Infinite (tokens, labels) batches, the i-th drawn with seed
        ``(seed or self.seed) + i`` (a seed of 0 counts as none), from a
        copy whose seed is overwritten at each batch: the reference's
        stream, batch for batch."""
        ds = ClassificationData(self.vocab, self.seq_len,
                                self.n_class_tokens,
                                seed if seed is not None else self.seed + 1)
        i = 0
        while True:
            ds.seed = (seed or self.seed) + i
            yield ds.sample(batch)[:2]
            i += 1
