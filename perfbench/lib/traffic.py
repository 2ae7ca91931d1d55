"""The one traffic generator: a mix file (``perfbench/traffic/<name>.json``)
of parameters in, a list of requests out.

Every request of a mix is queued before the window opens, a backlog
deeper than the window drains.  Its prompt and output lengths are drawn
once from the mix's ``sizes_seed`` and offered in that order for every
seed: the run's ``--seed`` only draws the prompt ids (uniform over the
vocabulary).  So every seed offers the same work in the same order, and
a difference between two runs is noise, not another load.

Keys of a mix file:

- ``requests``: how many the backlog holds;
- ``prompt``, ``output``: a length law, ``{"dist": "lognormal",
  "median", "sigma", "min", "max"}`` or ``{"dist": "uniform", "min",
  "max"}``;
- ``sample``: how many finished requests the correctness check compares;
- ``sizes_seed``: the seed of the lengths.

Every request decodes greedily and runs to its output length (no end
token).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Spec:
    rid: int
    prompt: np.ndarray    # int32 ids
    max_new: int


def rng_of(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator from a seed of any size or sign."""
    return np.random.default_rng([int(seed) % 2 ** 64, *salt])


def draw_lengths(law: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = int(law["min"]), int(law["max"])
    if law["dist"] == "lognormal":
        x = np.exp(rng.normal(math.log(law["median"]), law["sigma"], n))
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    if law["dist"] == "uniform":
        return rng.integers(lo, hi + 1, n)
    raise ValueError(f"unknown length law {law['dist']!r}")


def build(mix: dict, seed: int, vocab: int) -> list[Spec]:
    """The requests of one run, in the order they are offered."""
    n = int(mix["requests"])
    sizes = rng_of(int(mix["sizes_seed"]), 0)
    plens = draw_lengths(mix["prompt"], n, sizes)
    outs = draw_lengths(mix["output"], n, sizes)
    ids = rng_of(seed, 1)
    return [Spec(rid=i,
                 prompt=ids.integers(0, vocab, int(plens[i])).astype(np.int32),
                 max_new=int(outs[i]))
            for i in range(n)]
