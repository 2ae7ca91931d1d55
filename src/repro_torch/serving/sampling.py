"""Sampling for the decode window, ported from ``repro.serving.sampling``.

Every emission site of the generate engines (the decode window, the
prefill's first token and the legacy per-step loop) goes through
:func:`sample_token`, so there is one sampling rule, the reference's:

- **T = 0 is argmax, bitwise.**  ``temperature <= 0`` takes ``argmax``
  over the RAW logits, the op the greedy path has always used, so the
  greedy parity oracles hold unchanged.
- **Keys are request-derived, position-folded.**  The token written at
  absolute position ``q`` of request ``rid`` is sampled with
  ``fold_in(fold_in(PRNGKey(seed), rid), q)``: a slot reused across
  refill waves never replays its previous occupant's stream, and the
  stream does not depend on how the engine reached ``q``.
- **Shape-stable masking.**  ``top_k`` / ``top_p`` are per-row values
  (tensors), not shapes: top-k keeps the k highest logits by rank,
  top-p the minimal sorted prefix whose probability covers p.

The keys and the Gumbel noise are jax's own numbers, bit for bit: the
Threefry-2x32 hash (20 rounds, jax's ``_threefry2x32_lowering``),
``PRNGKey`` of a 32-bit seed, ``fold_in``, ``split`` and the bits of a
shape laid out as jax lays them out with ``jax_threefry_partitionable``
(the hash of the 64-bit counter ``(i >> 32, i & 0xFFFFFFFF)`` for flat
index ``i``, the two words XORed), then ``gumbel(mode="low")``:
``uniform = bitcast(bits >> 9 | 0x3F800000) - 1``, scaled into
``[tiny, 1)``, and ``-log(-log(u))``.  The hash has two forms from one
body: numpy ``uint64`` arrays on the host (``request_key``, one key per
seated slot) and torch ``int64`` tensors on the device (``step_keys``
and the Gumbel bits), each holding 32-bit words, every sum masked to 32
bits.  The tensor form has no host sync and no branch on a device value,
so it runs inside the decode window's CUDA graph.  ``torch.Generator``
draws other numbers and is not used.

Sorts follow ``jnp.argsort(x)[..., ::-1]``: a stable ascending sort
(-0.0 taken as 0.0), reversed, so ties in the descending order come out
highest index first.  :func:`sample_token` sorts once and derives both
masks from that one order; its masks equal :func:`top_k_mask` followed
by :func:`top_p_mask`, which sorts again (every entry the top-k mask
drops is -inf either way).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEG_INF = float("-inf")
_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float formats jax's ``_uniform`` draws into: (mantissa bits, the bits
# of 1.0, the signed integer type the bits are viewed through)
_FLOATS = {torch.float32: (23, 0x3F800000, torch.int32),
           torch.bfloat16: (7, 0x3F80, torch.int16),
           torch.float16: (10, 0x3C00, torch.int16)}


@dataclass(frozen=True)
class SamplingParams:
    """Per-request (or engine-default) sampling configuration.

    ``temperature=0`` is greedy decoding, bitwise the argmax path.
    ``top_k=0`` and ``top_p=1.0`` disable their filters.  ``seed``
    selects the base stream; per-request keys fold in the request id."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got "
                             f"{self.top_k}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got "
                             f"{self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


# ---------------------------------------------------------------------------
# Threefry-2x32, one body for numpy uint64 arrays and torch int64 tensors
# ---------------------------------------------------------------------------

def threefry2x32(k1, k2, x0, x1):
    """The hash of the counter pair (x0, x1) under key (k1, k2); every
    argument holds 32-bit words (broadcastable shapes).  -> (y0, y1)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _u64(x) -> np.ndarray:
    return np.asarray(x, np.uint64) & np.uint64(_MASK)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 32-bit integers (jax's
    default): ``[0, seed mod 2**32]``, uint32[2]."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` on the host: the hash of the
    counter ``(0, data)``.  key uint32[2] -> uint32[2]."""
    k = _u64(key)
    y0, y1 = threefry2x32(k[0], k[1], np.uint64(0), _u64(int(data) & _MASK))
    return np.array([y0, y1], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` (the partitionable layout: key i
    is the hash of the counter ``(0, i)``).  -> uint32[num, 2]."""
    k = _u64(key)
    y0, y1 = threefry2x32(k[0], k[1], np.zeros(num, np.uint64),
                          np.arange(num, dtype=np.uint64))
    return np.stack([y0, y1], -1).astype(np.uint32)


def request_key(seed: int, rid: int) -> np.ndarray:
    """Base key of one request: ``fold_in(PRNGKey(seed), rid)``, a
    function of (seed, rid) only, never of the slot.  A negative rid
    (the launcher's warm-up requests) wraps modulo 2**32, where the
    reference raises."""
    return fold_in(prng_key(seed), rid)


def step_keys(keys: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per-row emission keys: each slot's request key folded with the
    absolute position being written.  keys [B, 2] (32-bit words in any
    integer dtype), pos [B] -> [B, 2] int64."""
    k = keys.long() & _MASK
    y0, y1 = threefry2x32(k[:, 0], k[:, 1], torch.zeros_like(k[:, 0]),
                          pos.long() & _MASK)
    return torch.stack([y0, y1], -1)


def random_bits(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) for each row's key:
    keys [R, 2] -> [R, *shape] int64 holding 32-bit words."""
    n = int(np.prod(shape))
    i = torch.arange(n, dtype=torch.long, device=keys.device).reshape(shape)
    k = keys.long() & _MASK
    k1, k2 = (k[:, j].reshape(-1, *([1] * len(shape))) for j in (0, 1))
    y0, y1 = threefry2x32(k1, k2, i >> 32, i & _MASK)
    return y0 ^ y1


def gumbel_from_bits(bits: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """jax's ``gumbel(mode="low")`` of ``dtype`` from its random bits:
    a format under 8 mantissa bits (bf16) draws from the low 8 bits, as
    jax's ``_uniform`` does, then the uniform in ``[tiny, 1)`` and
    ``-log(-log(u))``."""
    nmant, one, itype = _FLOATS[dtype]
    width = torch.finfo(dtype).bits
    rng_bits = 8 if nmant < 8 else width
    if rng_bits < 32:
        bits = bits & ((1 << rng_bits) - 1)
    f = ((bits >> (rng_bits - nmant)) | one).to(itype).view(dtype) - 1.0
    tiny = torch.finfo(dtype).tiny
    u = torch.clamp_min(f * (1.0 - tiny) + tiny, tiny)
    return -torch.log(-torch.log(u))


def gumbel(keys: torch.Tensor, shape: tuple,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` for each row's key:
    keys [R, 2] -> [R, *shape]."""
    return gumbel_from_bits(random_bits(keys, shape), dtype)


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis for one
    host key (uint32[2]): Gumbel noise of the logits' shape and dtype
    from that one key, then argmax.  logits [B, V] -> [B]."""
    k = torch.as_tensor(np.asarray(key, np.int64)[None],
                        device=logits.device)
    g = gumbel(k, tuple(logits.shape), logits.dtype)[0]
    return (g + logits).argmax(-1)


# ---------------------------------------------------------------------------
# masking (value-dependent, shape-stable)
# ---------------------------------------------------------------------------

def descending_order(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(x, -1)[..., ::-1]``: stable ascending, reversed, so
    tied entries come highest index first; -0.0 sorts as 0.0."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    return torch.argsort(x, dim=-1, stable=True).flip(-1)


def _ranks(order: torch.Tensor) -> torch.Tensor:
    """The rank of each id in ``order`` (its inverse permutation, which
    is what the reference's argsort-of-argsort computes)."""
    iota = torch.arange(order.shape[-1], device=order.device)
    return torch.empty_like(order).scatter_(-1, order,
                                            iota.expand_as(order))


def _keep_top_k(logits, k, ranks):
    k = torch.as_tensor(k, device=logits.device).long()
    k_eff = torch.where(k > 0, k, logits.shape[-1])
    return torch.where(ranks < k_eff[..., None], logits, NEG_INF)


def _keep_top_p(logits, p, order, ranks):
    p = torch.as_tensor(p, device=logits.device).float()
    probs = torch.softmax(logits.gather(-1, order).float(), -1)
    csum = torch.cumsum(probs, -1)
    # sorted index i survives iff the mass BEFORE it is < p: the minimal
    # prefix whose cumulative mass reaches p; the top-1 always survives
    keep_sorted = (csum - probs) < p[..., None]
    keep_sorted[..., 0] = True
    keep = keep_sorted.gather(-1, ranks) | (p >= 1.0)[..., None]
    return torch.where(keep, logits, NEG_INF)


def top_k_mask(logits: torch.Tensor, k) -> torch.Tensor:
    """Keep exactly the k highest logits per row (k [B], 0 = all); the
    rest -> -inf.  Ranks break ties, so the kept count is exactly k."""
    return _keep_top_k(logits, k, _ranks(descending_order(logits)))


def top_p_mask(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus filter: keep the MINIMAL descending-probability prefix
    whose mass covers p (p [B], >= 1 disables); the rest -> -inf."""
    order = descending_order(logits)
    return _keep_top_p(logits, p, order, _ranks(order))


# ---------------------------------------------------------------------------
# the one sampling rule
# ---------------------------------------------------------------------------

def sample_token(keys: torch.Tensor, logits: torch.Tensor, temperature,
                 top_k, top_p) -> torch.Tensor:
    """One token per row.  keys [B, 2]; logits [B, V]; temperature,
    top_k, top_p [B].  Rows with ``temperature <= 0`` take argmax over
    the RAW logits; the others sample the temperature-scaled, top-k and
    top-p masked distribution by the Gumbel trick.  Both are computed
    for every row (no branch on a device value); a caller that knows
    the whole batch is greedy takes ``logits.argmax(-1)`` instead, as
    the reference's ``lax.cond`` does.  -> [B] int64."""
    temperature = torch.as_tensor(temperature,
                                  device=logits.device).float()
    greedy_tok = logits.argmax(-1)
    scaled = logits.float() / torch.clamp_min(temperature, 1e-6)[..., None]
    order = descending_order(scaled)
    ranks = _ranks(order)
    masked = _keep_top_p(_keep_top_k(scaled, top_k, ranks), top_p, order,
                         ranks)
    g = gumbel(keys, (logits.shape[-1],))
    tok = (masked + g).argmax(-1)
    return torch.where(temperature > 0.0, tok, greedy_tok)
