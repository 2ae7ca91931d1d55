"""Split-phase LM generation — the three-step API, ported from
``repro.disagg.engine``.

Pooled continuous batching runs prefill and decode on ONE device
line, so a long-prompt arrival stalls every in-flight decode slot
behind its prefill.  Disaggregation splits the phases:

  - ``prefill(request) -> PrefillResult``  — compute-bound: consume
    the prompt into a batch-1 contiguous ROW cache, emit the first
    token.  Runs on a prefill worker; on the card its attention is the
    flash-attention kernel (the model's ``"auto"`` dispatch).
  - ``insert(PrefillResult, session)``     — the hand-off: write the
    row cache into the decode pool's slot (contiguous ``slot_write``)
    or its block-table pages (``paged_slot_write``), both via
    ``DecodeSession.insert_prefilled``.
  - ``generate(session)``                  — HBM-bound: the session's
    decode window (``DecodeSession.advance``; a replayed CUDA graph on
    the card), untouched.

Parity invariant: the tokens a request decodes depend only on its
padded prompt length (padding IS attended; ``pos`` starts at
``plen``), never on which phase topology produced the KV.  A
``PrefillResult`` built at the same ``plen`` the pooled path would
pad to therefore yields the same greedy tokens
(``tests/test_torch_disagg.py``).  The reference pads contiguous rows to the
pool's ``max_seq`` so that one XLA compile serves every length; the
port compiles nothing, so it builds the rows at ``plen`` (paged: the
block multiple) and ``slot_write`` marks the pool's rows past them
invalid.

Set-up stays off every timed line.  On the card a ``PrefillEngine``
prefills once at every padded length when it is built (the kernels'
build and each shape's first call), and a session from
``start_session`` has captured its windows before it is handed out
(``DecodeSession.warm``); the reference pays its compiles inside its
first calls instead.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serving.continuous import (ContinuousBatchingEngine,
                                            DecodeSession, GenRequest,
                                            _bucket, first_tokens)
from repro_torch.serving.sampling import SamplingParams, request_key


@dataclass
class PrefillResult:
    """One prefilled request, ready to cross the phase boundary: the
    batch-1 row cache (on the device), the first token (host), and the
    padded prompt length the rows were built at (the decode pool must
    seat the request at exactly this position for parity with the
    pooled path)."""
    request: GenRequest
    rows: tfm.Cache                # contiguous, batch 1
    first_token: int
    plen: int
    kv_bytes: int                  # logical prompt-KV payload size


def prompt_kv_bytes(cfg: ModelConfig, plen: int) -> int:
    """Bytes of every leaf of a batch-1 contiguous cache of ``plen``
    rows that has a shape, as the reference counts them from its cache
    (``repro/disagg/engine.py:116-131``): the LOGICAL prompt-KV payload,
    not the padded physical row extent.  For attention that is K, V and
    the int32 positions, and on a homogeneous attention (or MLA) stack
    the reference's per-layer int32 length too (the port's cache keeps
    one length for the whole stack), but not the cache-wide scalar.
    stablelm-3b in bf16: 32 x (2 x 32 x 80 x 2 + 4) = 327,808 bytes a
    token, plus 32 x 4 bytes a prompt."""
    cache = tfm.init_cache(cfg, 1, plen, device="cpu", layout="contiguous")
    n = sum(t.numel() * t.element_size() for t in cache.leaves().values())
    if cfg.homogeneous and tfm.STATE_OF[cfg.block_kinds[0]] in ("kv",
                                                                 "latent"):
        n += 4 * cfg.n_layers
    return n


class PrefillEngine:
    """The compute-bound half: batch-1 prompt consumption into a row
    cache shaped for the decode pool's insert path — ``plen`` rows for a
    contiguous pool, the prompt's block multiple for a paged one
    (``paged_slot_write`` scatters whole blocks)."""

    def __init__(self, cfg: ModelConfig, params: tfm.LM,
                 max_seq: int = 256, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params.to(self.device).eval()
        self.max_seq = max_seq
        self.paged = cfg.paged_kv
        self._kv_bytes: dict[int, int] = {}
        self.prefill_calls = 0
        self.device_s = 0.0
        if self.device.type == "cuda":
            self.warm()

    def warm(self) -> None:
        """One untimed prefill at every padded length ``pad_len`` can
        give, so that no timed prefill pays for building a kernel or for
        the first call at its shape.  Neither counted nor timed."""
        sp = self.default_sampling()
        for plen in sorted({self.pad_len(n)
                            for n in range(1, self.max_seq + 1)}):
            _, first = self._prefill1(np.zeros((1, plen), np.int64),
                                      plen, sp, 0)
            first.item()

    def _row_len(self, plen: int) -> int:
        if not self.paged:
            return plen
        bs = self.cfg.kv_block_size
        return (-(-plen // bs)) * bs

    def pad_len(self, prompt_tokens: int,
                prompt_len: int | None = None) -> int:
        """The padded prompt length this request prefills at — the
        SAME rule the pooled ``DecodeSession._refill`` applies, so the
        two topologies stay token-identical."""
        if prompt_len is not None:
            return prompt_len
        return min(_bucket(max(prompt_tokens, 1)), self.max_seq - 1)

    def kv_bytes(self, plen: int) -> int:
        """Logical bytes of prompt KV crossing the phase boundary
        (:func:`prompt_kv_bytes`), computed once per plen."""
        n = self._kv_bytes.get(plen)
        if n is None:
            n = self._kv_bytes[plen] = prompt_kv_bytes(self.cfg, plen)
        return n

    def default_sampling(self) -> SamplingParams:
        return SamplingParams(temperature=self.cfg.temperature,
                              top_k=self.cfg.sample_top_k,
                              top_p=self.cfg.sample_top_p,
                              seed=self.cfg.sampling_seed)

    @torch.no_grad()
    def _prefill1(self, toks: np.ndarray, plen: int, sp: SamplingParams,
                  rid: int):
        """The prompt through the model into a fresh row cache; the
        first token lands at absolute position ``plen``, drawn under
        the request's position-folded key (T = 0: the argmax), as the
        pooled prefill draws it."""
        dev = self.device
        rows = tfm.init_cache(self.cfg, 1, self._row_len(plen), device=dev,
                              layout="contiguous")
        logits, rows = self.params.prefill(torch.from_numpy(toks).to(dev),
                                           rows)
        sampling = [torch.as_tensor(x, device=dev) for x in (
            request_key(sp.seed, rid).astype(np.int64)[None],
            np.array([sp.temperature], np.float32),
            np.array([sp.top_k], np.int64),
            np.array([sp.top_p], np.float32))]
        first = first_tokens(logits[:, -1], plen, sampling,
                             sp.temperature > 0)
        return rows, first

    def prefill(self, r: GenRequest, *,
                prompt_len: int | None = None) -> PrefillResult:
        plen = self.pad_len(len(r.prompt), prompt_len)
        toks = np.zeros((1, plen), np.int64)
        p = np.asarray(r.prompt[:plen], np.int64)
        toks[0, :len(p)] = p
        sp = (r.sampling if r.sampling is not None
              else self.default_sampling())
        t0 = time.perf_counter()
        rows, first = self._prefill1(toks, plen, sp, r.rid)
        # the host read of the first token waits for the card's work, so
        # the span is the prefill's, not its launch's
        first_h = int(first.item())
        self.device_s += time.perf_counter() - t0
        self.prefill_calls += 1
        return PrefillResult(request=r, rows=rows, first_token=first_h,
                             plen=plen, kv_bytes=self.kv_bytes(plen))


@dataclass
class DisaggEngine:
    """Facade binding the two halves: the split-phase engine API.

    ``prefill`` runs on the :class:`PrefillEngine`; ``insert`` lands a
    :class:`PrefillResult` in a :class:`DecodeSession` (seated on the
    session's next ``advance``); ``generate`` runs one decode window.
    Sessions come from ``start_session`` — the decode pool's slot and
    block ownership rules are entirely the session's.  Both halves
    share one copy of the weights."""
    decode: ContinuousBatchingEngine
    prefill_engine: PrefillEngine

    @classmethod
    def build(cls, cfg: ModelConfig, params: tfm.LM, *,
              n_slots: int = 4, max_seq: int = 64,
              sync_every: int = 8, draft_depth: int = 0,
              device="cuda", capture="auto") -> "DisaggEngine":
        decode = ContinuousBatchingEngine(cfg, params, n_slots=n_slots,
                                          max_seq=max_seq,
                                          sync_every=sync_every,
                                          draft_depth=draft_depth,
                                          device=device, capture=capture)
        return cls(decode=decode,
                   prefill_engine=PrefillEngine(cfg, decode.params,
                                                max_seq=max_seq,
                                                device=decode.device))

    def prefill(self, r: GenRequest, *,
                prompt_len: int | None = None) -> PrefillResult:
        return self.prefill_engine.prefill(r, prompt_len=prompt_len)

    def insert(self, pr: PrefillResult, session: DecodeSession) -> None:
        session.insert_prefilled(pr.request, pr.rows, pr.first_token,
                                 pr.plen)

    def generate(self, session: DecodeSession) -> list[GenRequest]:
        return session.advance()

    def start_session(self) -> DecodeSession:
        """A fresh decode session, its windows already captured."""
        return DecodeSession(self.decode).warm()
