"""Continuous batching for LM decode, ported from
``repro.serving.continuous`` (the contiguous KV layout, the paged
block pool, the recurrent state of an SSD stack and a mixed stack's
ring rows and RG-LRU state; sampling; self-speculative windows; the
legacy per-step loop).  An encoder-decoder is refused when the engine
is built: it feeds no encoder input.

A fixed pool of B slots over one shared KV cache; every decode step
advances ALL slots (each at its own absolute position, the decoder's
per-row ``pos`` path), finished slots are refilled from the queue.
Decode is the regime where energy follows occupied slot-steps, so the
admission controller (enqueue-time middleware) prunes low-value
requests before they ever take a slot.

Invariants, as the reference's:

- **Slot ownership.**  A slot belongs to one ``GenRequest`` from the
  prefill that seats it until the host sync that harvests its
  completion; only ``DecodeSession`` assigns or clears slots.  Between
  host syncs all slot state (KV pool, ``cur_tok``, ``pos``, ``active``,
  ``remaining``, ``eos`` and the sampling rows ``skey``, ``temp``,
  ``topk``, ``topp``) lives on the device.
- **One host sync per window.**  A window is ``sync_every`` decode
  steps; sampling, the done-masks (EOS, budget, the ``max_seq - 1``
  stop) and the positions stay on the device as in the reference's
  ``step_k``, and the tokens, emission masks and live flags come back
  in ONE copy at the end of the window.  Where the reference compiles
  the window once (``jax.jit`` of a ``lax.scan``), the port captures it
  once per session and kind as a CUDA graph and replays it for every
  later window (``capture="auto"`` on the card; the CPU, and
  ``capture=False``, issue the same ops from Python).  The kind is
  picked on the host from the seated slots' temperatures, in place of
  the reference's ``lax.cond``: ``greedy`` (argmax only) or ``sampled``
  (``sample_token``, whose T = 0 rows are that same argmax), so the
  tokens do not depend on it.  Every state tensor keeps its storage for
  the session's life: seating, the slot writes and the table copy write
  into it, and the window writes its results back into it, so a replay
  reads and writes what the capture saw.  The cache is updated IN
  PLACE (the reference donates it).  An SSD stack's pool is its
  per-slot recurrent state (conv tail and SSD state), stepped in place
  the same way; a slot that is not active keeps stepping inside a
  window, as in the reference, and its state is overwritten whole when
  the slot is next seated.
- **Refill.**  Up to ``n_free`` queued prompts are prefilled in one
  call into a row cache whose rows are then written into their slots
  (``slot_write``), with the per-slot decode state set in the same
  pass; the first token is sampled with ``step_keys(skey, plen)``.
  The reference pads that batch to a power-of-two bucket of zero-token
  rows so each bucket compiles once; PyTorch compiles nothing per
  shape, so the port prefills only the real rows (sampling is row by
  row, so the padding changes no token), except on an MoE stack: its
  router groups every token of the call, the padding rows' included,
  so which tokens an expert drops depends on them, and the port pads
  as the reference does (``prefill_rows``).  The prompt length keeps
  the reference's rule (``prompt_len``, or the wave's longest prompt
  rounded up to a bucket), since positions depend on it.
- **Block ownership (paged pool, ``cfg.kv_block_size > 0``).**  KV
  rows live in one shared pool of ``pool_blocks`` x ``kv_block_size``
  rows per layer; a request owns the blocks of its slot's table row
  from its prefill until the host sync that completes it.
  ``DecodeSession`` is the ONLY allocator: a request's whole budget
  (``blocks_for_request``) is reserved before it is seated, so a window
  never runs out of blocks; blocks are freed at completion (and at an
  EOS straight out of prefill); the queue is FIFO and its head WAITS
  while the pool cannot cover its budget — never dropped, never
  overtaken; a request no pool state could serve raises before any
  block is taken.  Block 0 is the trash block, never allocated:
  retired slots still stepped inside a window write there, and the
  per-slot ``pos`` keeps those rows invalid.  The host table is copied
  to the device table before every window that follows a change, so a
  freed (and maybe reallocated) block is never written by its old
  slot.  The prefill goes through a contiguous row cache of the
  prompt's block multiple, scattered block by block
  (``paged_slot_write``).  The contiguous layout stays the parity
  oracle: the same tokens.
- **Legacy loop.**  ``serve(..., legacy=True)`` runs the reference's
  per-step host loop (``_serve_legacy``): a batch-1 prefill per
  request, one host sync per step.  It is the third parity path, held
  against the window; contiguous and SSD stacks only, as the reference
  refuses paged configs.  It steps the full model one token at a time
  whatever ``draft_depth`` is, as the reference's does.
- **Self-speculative windows (``draft_depth`` D > 0).**  Each of the
  window's ``sync_every`` macro-steps drafts D tokens through the first
  ``cfg.draft_layers`` layers (``draft_prefix``), verifies ``[tok,
  drafts]`` in one full-model ``decode_chunk``, and emits the longest
  accepted prefix plus the full model's own next token, every emitted
  token the full model's sample under the same position-folded key, so
  the stream equals the non-speculative one (ref
  ``continuous.py:427-518``).  The live depth (``current_depth``, the
  ``DraftDepthController``'s choice) caps acceptance only: it reaches
  the window as the session's ``depth_cap`` device scalar, written
  before each window, so moving it never recaptures the graph; the
  window always drafts D steps, as the reference's.  The reference
  drafts on a sliced scratch copy of the first layers' cache and
  discards it; the port drafts on the pool's own rows with the decode
  step's ring write (``_draft``), saving the rows the draft writes
  before and putting them back after, so every draft reads what the
  reference's reads, past the cache's last row too (there the ring
  wraps onto the first rows), and the verify finds the pool the
  reference's finds.  Tokens and stats equal the reference's, an MoE
  stack's too, whose router groups every slot's draft token at once.
  Paged and SSD engines refuse D > 0 with the reference's errors.

- **Insert (the disaggregated hand-off).**  ``insert_prefilled`` takes
  a request prefilled elsewhere (``repro_torch.disagg``): a batch-1
  contiguous row cache, its first token and its padded prompt length.
  It waits in a FIFO insert queue and is seated at the start of the
  next ``advance``, before any refill, into the first free slot
  (``slot_write``) or, on a paged pool, into blocks of its whole budget
  taken from the session's own allocator (``paged_slot_write``) — the
  head waits while no slot, or not enough blocks, are free; a request
  whose first token is its EOS completes on the host and never takes a
  slot (ref ``continuous.py:1001-1092``).  Like a refill it writes the
  pool and the slot state in place, so a window captured before the
  insert reads the inserted rows when it is replayed.

- **Spans and counters.**  A session's ``tracer`` (``NULL_TRACER``
  unless ``start_session(tracer=...)`` passes one) records each
  ``advance`` as a tree of host spans: ``decode.advance``, and under it
  ``decode.insert``, ``decode.refill`` (``.alloc``, ``.prefill``,
  ``.scatter``, ``.first``: the row cache, the prefill, its write into
  the pool, the first tokens and their host sync), ``decode.window.issue``
  (the graph's replay), ``decode.window.sync`` (the one copy back) and
  ``decode.harvest`` (the slots' tokens and completions).  With a
  ``WallClock`` tracer the spans lie on a ``torch.profiler`` trace's
  timeline (``WallClock.epoch_ns``), so the card's idle time in an
  operator's trace can be put down to them.  The counters in
  ``stats()`` are kept whether or not a tracer is on: ``device_s``,
  ``prefill_s`` and ``window_issue_s`` as before, the sync's wait
  (``window_sync_s``), the harvest (``harvest_s``), and the caller's
  own time between one ``advance`` and the next while slots are active
  (``caller_s``).  No span is a ``record_function`` range: the
  profiler would give those a device-side copy.  ``work`` counts, for
  prefill and decode apart, what the model's layers did, from the
  shapes of each call (``tfm.step_work``) and, for decode, multiplied
  by the steps each window replays, with no operation added to a step:
  the (token, expert) pairs the MoE layers route (``moe_pairs``), the
  expert rows their products multiply (``moe_rows``), and the latent
  rows an MLA decode scores (``latent_rows``).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import (AdmissionController,
                                         DraftDepthController)
from repro_torch.kernels.graphs import CountedGraph
from repro_torch.kernels.runtime import resolve_device, synchronize
from repro_torch.models import transformer as tfm
from repro_torch.serving import sampling as smp
from repro_torch.serving.engine import bucket_size
from repro_torch.serving.sampling import SamplingParams
from repro_torch.telemetry.trace import NULL_TRACER, Tracer


@dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray               # [S] int32
    max_new: int = 16
    entropy_hint: float = 0.5        # L(x) proxy at enqueue time
    arrival_t: float | None = None   # admission clock (workload arrival_s)
    eos_id: int | None = None        # stop after emitting this token
    sampling: SamplingParams | None = None   # None = engine default

    generated: list = field(default_factory=list)
    done: bool = False
    admitted: bool = True
    slot: int | None = None          # decode slot it occupied (telemetry)


@dataclass
class SlotClock:
    """The virtual-time core of the slot-pool decode model: ``n_slots``
    independent free-at lines, new work landing in the earliest-free
    slot.  ``pressure(now)`` is how long a NEW arrival would wait for a
    slot (zero while any slot is free), ``busy(now)`` the live
    occupancy.  Side-effect-free to poll."""
    n_slots: int = 8
    free_at: list[float] = field(default_factory=list)

    def __post_init__(self):
        if not self.free_at:
            self.free_at = [0.0] * self.n_slots

    def reserve(self, now: float, dur: float) -> tuple[int, float, float]:
        """Seat ``dur`` seconds of decode in the earliest-free slot."""
        i = min(range(self.n_slots), key=lambda s: self.free_at[s])
        start = max(now, self.free_at[i])
        finish = start + dur
        self.free_at[i] = finish
        return i, start, finish

    def pressure(self, now: float) -> float:
        return max(min(self.free_at) - now, 0.0)

    def busy(self, now: float) -> int:
        return sum(f > now for f in self.free_at)

    def reset(self) -> None:
        self.free_at = [0.0] * self.n_slots


def slot_write(pool: tfm.Cache, rows: tfm.Cache,
               slot_idx: np.ndarray) -> None:
    """Write row i of a batched row cache into pool slot ``slot_idx[i]``,
    in place, every kind of state the stack holds.  Rows whose index is
    out of range (>= n_slots) are dropped, as the reference's
    ``.at[slot_idx].set(mode="drop")`` drops its bucket-padding rows: the
    valid rows are selected explicitly on the host, since
    ``index_copy_`` raises on such an index and a scatter with repeated
    indices has no defined order on the card.  A repeated valid index
    raises.  A slot's attention (or MLA latent) rows are its prompt's;
    its position row is rewritten whole (the prompt's rows, -1 beyond),
    which retires any validity left by its previous occupant.  Its
    recurrent states (SSD, RG-LRU) are written whole, which retires the
    state left by its previous occupant.  A mixed stack's slot is all of
    these at once, one indexed write per stacked tensor."""
    slot_idx = np.asarray(slot_idx)
    if len(slot_idx) != rows.n_slots:
        raise ValueError(f"{len(slot_idx)} slot indices for a row cache "
                         f"of {rows.n_slots} rows")
    pl, rl = pool.leaves(), rows.leaves()
    if pl.keys() != rl.keys() or pool.index != rows.index:
        raise ValueError(f"a recurrent-state, latent (MLA) and KV cache do "
                         f"not mix: pool {sorted(pl)}, rows {sorted(rl)}")
    for name, p in pl.items():
        r = rl[name]
        if name in tfm.Cache.STATES:
            ok = p.shape[0] == r.shape[0] and p.shape[2:] == r.shape[2:]
        else:
            ok = (p.shape[0] == r.shape[0] and p.shape[3:] == r.shape[3:]
                  and r.shape[2] <= p.shape[2])
        if not ok:
            raise ValueError(f"row cache {name} {tuple(r.shape)} does not "
                             f"fit pool {tuple(p.shape)} — refusing to drop "
                             f"the prefilled rows")
    keep = np.nonzero((slot_idx >= 0) & (slot_idx < pool.n_slots))[0]
    dst = slot_idx[keep]
    if len(set(dst.tolist())) != len(dst):
        raise ValueError(f"repeated slot index in {slot_idx.tolist()}")
    if len(keep) == 0:
        return
    dev = next(iter(pl.values())).device
    src = torch.as_tensor(keep, device=dev)
    dst = torch.as_tensor(dst, device=dev)
    for name, p in pl.items():
        r = rl[name][:, src]
        if name == "pos" and r.shape[2] < p.shape[2]:
            r = torch.cat([r, r.new_full((*r.shape[:2],
                                          p.shape[2] - r.shape[2]), -1)],
                          dim=2)
        if name in tfm.Cache.ROWS:
            p[:, dst, :r.shape[2]] = r
        else:
            p[:, dst] = r


def paged_slot_write(pool: tfm.Cache, rows: tfm.Cache, slot_idx,
                     table_rows, *, block_size: int,
                     n_pref_blocks: int) -> None:
    """Scatter a contiguous prefill ROW cache into paged pool blocks, in
    place (ref ``continuous.py:228-263``).  ``rows`` has one row per
    entry of ``slot_idx``, its first ``n_pref_blocks * block_size`` rows
    holding the prompt; ``table_rows`` [n, MB] is each row's FULL table
    row (prompt and decode-budget blocks, trash-padded).  The K/V
    scatter is block-granular: the first ``n_pref_blocks`` entries of
    each table row receive the row cache's blocks.  As the reference's
    ``mode="drop"``, a slot index >= n_slots or a table entry >= the
    pool's block count is not written (selected on the host); a
    repeated destination block raises, since one indexed write with
    repeated indices has no defined order on the card.  The slot's pos
    row is rewritten whole (the prompt's rows, -1 beyond), which
    retires any validity left by its previous occupant, and its device
    table row is set."""
    slot_idx = np.asarray(slot_idx)
    table_rows = np.asarray(table_rows)
    L, NB, bs = pool.k.shape[:3]
    B, C = pool.pos.shape[1:]
    P = n_pref_blocks * block_size
    if bs != block_size:
        raise ValueError(f"block_size {block_size} is not the pool's {bs}")
    if len(slot_idx) != rows.n_slots or table_rows.shape != (
            len(slot_idx), pool.block_table.shape[1]):
        raise ValueError(f"{len(slot_idx)} slot indices and table rows "
                         f"{table_rows.shape} for a row cache of "
                         f"{rows.n_slots} rows and a table "
                         f"{tuple(pool.block_table.shape)}")
    if (rows.k.shape[0] != L or rows.k.shape[3:] != pool.k.shape[3:]
            or rows.k.shape[2] < P or P > C):
        raise ValueError(f"row cache {tuple(rows.k.shape)} does not fit "
                         f"{n_pref_blocks} blocks of pool "
                         f"{tuple(pool.k.shape)} — refusing to drop the "
                         f"prefilled rows")
    dev = pool.k.device
    tb = table_rows[:, :n_pref_blocks]
    j, i = np.nonzero((tb >= 0) & (tb < NB))
    dst = tb[j, i]
    if len(set(dst.tolist())) != len(dst):
        raise ValueError(f"repeated pool block in {tb.tolist()}")
    if len(dst):
        nr = rows.n_slots
        src_k = rows.k[:, :, :P].reshape(L, nr, n_pref_blocks, bs,
                                         *rows.k.shape[3:])
        src_v = rows.v[:, :, :P].reshape(L, nr, n_pref_blocks, bs,
                                         *rows.v.shape[3:])
        jt = torch.as_tensor(j, device=dev)
        it = torch.as_tensor(i, device=dev)
        dt = torch.as_tensor(dst, device=dev)
        pool.k[:, dt] = src_k[:, jt, it].to(pool.k.dtype)
        pool.v[:, dt] = src_v[:, jt, it].to(pool.v.dtype)
    keep = np.nonzero((slot_idx >= 0) & (slot_idx < B))[0]
    if len(keep) == 0:
        return
    slots = slot_idx[keep]
    if len(set(slots.tolist())) != len(slots):
        raise ValueError(f"repeated slot index in {slot_idx.tolist()}")
    src = torch.as_tensor(keep, device=dev)
    st = torch.as_tensor(slots, device=dev)
    pos = rows.pos[:, src, :P]
    pool.pos[:, st] = torch.cat(
        [pos, pos.new_full((*pos.shape[:2], C - P), -1)], dim=2)
    pool.block_table[st] = torch.as_tensor(
        table_rows[keep], dtype=torch.int32, device=dev)


def blocks_for_request(plen: int, max_new: int, max_seq: int,
                       block_size: int) -> int:
    """Pool blocks a request needs for its WHOLE lifetime: the padded
    prompt's rows plus one per decode step, plus the frozen-position
    row a retired slot keeps rewriting inside a window (hence
    ``max(max_new, 2)``), clamped by the ``max_seq`` stop.  Reserving
    it up front makes pool exhaustion a queue-time condition."""
    rows = min(plen + max(max_new, 2), max_seq)
    return -(-rows // block_size)


def pool_hbm_bytes(cfg: ModelConfig, n_slots: int, max_seq: int,
                   dtype=torch.bfloat16) -> dict:
    """Device bytes of the decode cache the engine would hold, from the
    geometry alone (nothing is allocated), counted as the reference
    counts the leaves of its cache (``continuous.py:280-303``):
    ``kv_bytes`` (the K/V rows, the part paging shrinks), ``meta_bytes``
    (positions, the block table, the per-layer and cache-wide length
    scalars and an encoder-decoder's cross K/V) and their sum, for the
    layout that ``cfg.kv_block_size`` selects.  Where the reference
    finds no stacked ``kv.k`` leaf (an SSD, MLA or mixed stack) it counts
    every byte as ``kv_bytes``, with no ``meta_bytes``."""
    if cfg.paged_kv:
        tfm._check_paged_supported(cfg)
    L, B = cfg.n_layers, n_slots
    K, hd = cfg.n_kv_heads, cfg.head_dim
    item = torch.empty((), dtype=dtype).element_size()
    if cfg.paged_kv:
        mb, C, nb = tfm.paged_geometry(cfg, B, max_seq)
        kv = 2 * L * nb * cfg.kv_block_size * K * hd * item
        meta = 4 * (L * B * C + L + 1 + B * mb)
        return {"kv_bytes": kv, "meta_bytes": meta, "total_bytes": kv + meta}
    C = tfm.kv_rows(cfg, max_seq)
    R = cfg.lru_width or cfg.d_model
    d_inner = cfg.ssm_expand * cfg.d_model
    per_layer = {    # the layer's leaves, its length scalar included
        "kv": 2 * B * C * K * hd * item + 4 * B * C + 4,
        "latent": (B * max_seq * ((cfg.kv_lora_rank + cfg.qk_rope_dim)
                                  * item + 4) + 4),
        "ssd": 4 * B * ((cfg.ssm_conv - 1) * (d_inner + 2 * cfg.ssm_state)
                        + (d_inner // cfg.ssm_headdim) * cfg.ssm_headdim
                        * cfg.ssm_state),
        "rglru": 4 * B * cfg.conv_width * R,      # h and W-1 rows of tail
    }
    total = sum(per_layer[tfm.STATE_OF[k]] for k in cfg.block_kinds) + 4
    if cfg.family == "encdec":
        total += 2 * L * B * cfg.enc_seq * K * hd * item
    kinds = cfg.block_kinds
    kv = (2 * L * B * C * K * hd * item
          if cfg.homogeneous and tfm.STATE_OF[kinds[0]] == "kv" else total)
    return {"kv_bytes": kv, "meta_bytes": total - kv, "total_bytes": total}


WORK = ("moe_pairs", "moe_rows", "latent_rows")


def window_work(eng: "ContinuousBatchingEngine") -> dict:
    """``tfm.step_work`` of one decode window of ``eng``: ``sync_every``
    steps over every slot at the pool's rows, or, speculative, as many
    macro-steps of ``draft_depth`` draft steps through the draft layers
    and one verify chunk of ``draft_depth + 1`` tokens."""
    cfg, B, D = eng.cfg, eng.n_slots, eng.draft_depth
    if D == 0:
        one = tfm.step_work(cfg, B, 1, cache_rows=eng.max_seq)
    else:
        chunk = tfm.step_work(cfg, B, D + 1)
        draft = tfm.step_work(cfg, B, 1, cache_rows=eng.max_seq,
                              n_layers=cfg.draft_layers)
        one = {k: chunk[k] + D * draft[k] for k in WORK}
    return {k: eng.sync_every * v for k, v in one.items()}


def _add_work(into: dict, work: dict) -> None:
    for k in WORK:
        into[k] += work[k]


def _bucket(n: int) -> int:
    """The serving-wide power-of-two bucket, never below ``n``."""
    return max(bucket_size(n), n)


def first_tokens(last: torch.Tensor, plen: int, rows,
                 sampled: bool) -> torch.Tensor:
    """The prefill's first token of each row from its last-position
    logits [n, V] and its sampling rows (skey, temp, topk, topp) on the
    device: sampled with ``step_keys(skey, plen)``, the request's key
    folded with the position the token lands at (ref
    ``continuous.py:579, 622``), or, when no row samples (``sampled``,
    decided on the host), the argmax (``sample_token``'s T = 0 rows are
    that same argmax)."""
    if sampled:
        at = torch.full((len(last),), plen, dtype=torch.long,
                        device=last.device)
        return smp.sample_token(smp.step_keys(rows[0], at), last, *rows[1:])
    return last.argmax(-1)


def _wave_arrays(reqs: list[GenRequest], plen: int, rows: int):
    """A refill wave's prompts padded (or cut) to ``plen`` in ``rows``
    rows (zero-token rows past the wave), its decode budgets after the
    prefill's token, and its EOS ids (-1 = none)."""
    toks = np.zeros((rows, plen), np.int64)
    rem_new = np.ones(len(reqs), np.int64)
    eos_new = np.full(len(reqs), -1, np.int64)
    for j, r in enumerate(reqs):
        p = np.asarray(r.prompt[:plen])
        toks[j, :len(p)] = p
        rem_new[j] = max(r.max_new - 1, 1)
        if r.eos_id is not None:
            eos_new[j] = int(r.eos_id)
    return toks, rem_new, eos_new


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclass
class ContinuousBatchingEngine:
    cfg: ModelConfig
    params: tfm.LM
    n_slots: int = 8
    max_seq: int = 256
    controller: AdmissionController | None = None
    sync_every: int = 8              # decode (macro-)steps per host sync
    # self-speculative decoding: > 0 makes each window step a macro-step
    # that drafts ``draft_depth`` tokens through the first
    # ``cfg.draft_layers`` layers and verifies them in one full-model
    # chunk.  The draft depth is the CEILING; the live depth (the session's
    # ``depth_cap`` device scalar) is the energy lever ``spec_controller``
    # moves with no new capture
    draft_depth: int = 0
    device: str | torch.device = "cuda"
    capture: bool | str = "auto"     # the decode window as a CUDA graph
    spec_controller: DraftDepthController | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.sync_every = max(int(self.sync_every), 1)
        cfg = self.cfg
        # the reference's checks, in its order (ref continuous.py:339-364)
        if self.draft_depth < 0:
            raise ValueError(
                f"draft_depth must be >= 0, got {self.draft_depth}")
        if self.draft_depth > 0:
            if cfg.paged_kv:
                raise ValueError(
                    "self-speculative decoding serves the contiguous "
                    "KV layout only (the verify chunk is a multi-row "
                    "scatter the paged pool cannot express); set "
                    "draft_depth=0 for paged engines")
            if cfg.draft_layers <= 0:
                raise ValueError(
                    "draft_depth > 0 needs cfg.draft_layers in "
                    "[1, n_layers) — the draft is a shallow prefix of "
                    "the same stack")
            kinds = set(cfg.block_kinds)
            if not kinds <= {"attn", "local_attn"} \
                    or cfg.family == "encdec":
                raise ValueError(
                    f"self-speculative decoding needs a pure attention "
                    f"stack; got kinds={sorted(kinds)} "
                    f"family={cfg.family}")
            if self.spec_controller is None:
                self.spec_controller = DraftDepthController(
                    max_depth=self.draft_depth,
                    draft_cost=cfg.draft_layers / cfg.n_layers)
        if cfg.family == "encdec":
            # the reference's engine prefills no encoder input and fails
            # inside its first prefill; the port says so when it is built
            raise ValueError(
                f"{cfg.arch_id} is an encoder-decoder: the continuous "
                f"engine feeds prompts only, no encoder input (enc_embeds), "
                f"so it cannot serve it — drive it through the model API "
                f"(LM.prefill(..., enc_embeds=...), then decode_step)")
        if self.capture == "auto":
            self.graphed = self.device.type == "cuda"
        elif self.capture is True or self.capture is False:
            if self.capture and self.device.type != "cuda":
                raise ValueError(
                    f"capture=True needs a CUDA device, got {self.device}: "
                    f"a CUDA graph holds only the card's work (capture="
                    f"'auto' runs the window uncaptured on the CPU)")
            self.graphed = self.capture
        else:
            raise ValueError(f"capture must be 'auto', True or False, got "
                             f"{self.capture!r}")
        # windows captured, by kind, over every session of this engine
        self.decode_captures = {"greedy": 0, "sampled": 0}
        self._side = None
        self.params = self.params.to(self.device).eval()
        # the draft: a view over the first draft_layers layers, no copy
        self.draft = (self.params.draft_prefix(cfg.draft_layers)
                      if self.draft_depth > 0 else None)
        self.paged = self.cfg.paged_kv
        if self.paged:
            tfm._check_paged_supported(self.cfg)
            (self.blocks_per_slot, self.logical_len,
             self.pool_blocks) = tfm.paged_geometry(self.cfg, self.n_slots,
                                                    self.max_seq)

    def side_stream(self) -> torch.cuda.Stream:
        """The stream each session's first window of a kind runs on
        before it is captured: one for the engine's life.  cuBLAS keeps
        a workspace for every stream it has run on (32 MiB each on an
        NVIDIA H100 80GB HBM3, 700.00 W: ``chip_smoke.py``'s
        ``disagg_chaos``), so a new stream per session would leave one
        more behind at every session a fleet builds, a crashed worker's
        included."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    @property
    def decode_capture_count(self) -> int:
        """How many times the decode window has been captured as a CUDA
        graph: the counterpart of the reference's
        ``decode_compile_count``, one per session and kind (greedy,
        sampled), however many windows and refills follow."""
        return sum(self.decode_captures.values())

    @property
    def default_sampling(self) -> SamplingParams:
        """Engine-level sampling defaults (from the model config); a
        request's own ``SamplingParams`` override them."""
        return SamplingParams(temperature=self.cfg.temperature,
                              top_k=self.cfg.sample_top_k,
                              top_p=self.cfg.sample_top_p,
                              seed=self.cfg.sampling_seed)

    def current_depth(self) -> int:
        """Live speculative depth for the next window: the
        spec_controller's energy-aware choice, clamped into
        [1, draft_depth] (the captured ceiling); ref
        ``continuous.py:543-559``."""
        if self.draft_depth <= 0:
            return 0
        if self.spec_controller is None:
            return self.draft_depth
        if self.controller is not None:
            # brownout / admission pressure couples in: a shrunken
            # admission basin inflates the perceived draft cost
            self.spec_controller.tau_scale = self.controller.tau_scale
        d = self.spec_controller.decide()
        d = max(1, min(int(d), self.draft_depth))
        if self.controller is not None:
            self.controller.draft_depth_norm = d / self.draft_depth
        return d

    def prefill_rows(self, n: int) -> int:
        """Rows of a refill wave of ``n`` prompts: the reference's
        power-of-two bucket on an MoE stack, whose routing groups the
        padding rows with the prompts; ``n`` elsewhere."""
        return _bucket(n) if self.cfg.is_moe else n

    def init_cache(self, batch: int, max_seq: int | None = None, *,
                   layout: str = "auto") -> tfm.Cache:
        return tfm.init_cache(self.cfg, batch, max_seq or self.max_seq,
                              device=self.device, layout=layout)

    @torch.no_grad()
    def step_window(self, pool, cur_tok, pos, active, remaining, eos,
                    sampling=None):
        """``sync_every`` decode steps with the reference's on-device
        masks (``continuous.py:402-425``); the pool is updated in place.
        ``sampling`` is None (every row greedy: argmax) or the slots'
        (skey, temp, topk, topp): the token written at position q is
        ``sample_token(step_keys(skey, q), ...)``.  Returns the new
        (cur_tok, pos, active, remaining) and the tokens and emission
        masks, both [k, B], all on the device; no host sync."""
        model, last = self.params, self.max_seq - 1
        toks, emitted = [], []
        for _ in range(self.sync_every):
            logits, pool = model.decode_step(cur_tok, pool, pos)
            if sampling is None:
                nxt = logits[:, 0].argmax(-1)
            else:
                skey, temp, topk, topp = sampling
                nxt = smp.sample_token(smp.step_keys(skey, pos + 1),
                                       logits[:, 0], temp, topk, topp)
            new_pos = torch.where(active, pos + 1, pos)
            new_rem = torch.where(active, remaining - 1, remaining)
            alive = (active & (new_rem > 0) & (new_pos < last)
                     & (nxt != eos))
            cur_tok = torch.where(active, nxt, cur_tok[:, 0])[:, None]
            toks.append(nxt)
            emitted.append(active)
            pos, remaining, active = new_pos, new_rem, alive
        return (cur_tok, pos, active, remaining, torch.stack(toks),
                torch.stack(emitted))

    @torch.no_grad()
    def step_window_spec(self, pool, cur_tok, pos, active, remaining, eos,
                         depth_cap, sampling=None):
        """``sync_every`` speculative macro-steps (ref
        ``continuous.py:427-518``), the pool updated in place.  Each
        drafts ``draft_depth`` tokens through the draft prefix (the token
        at position q sampled with ``step_keys(skey, q)``), verifies
        ``[tok, drafts]`` in one ``decode_chunk``, samples the full model
        at ``pos+1 .. pos+D+1`` under the same keys, and emits along the
        acceptance chain: emission j is live while every draft before it
        matched the full model and ``j <= depth_cap`` (a device scalar),
        and EOS, budget and the ``max_seq - 1`` stop retire a slot inside
        the chain as the per-step window does.  Returns the new
        (cur_tok, pos, active, remaining) and the tokens and emission
        masks, both [k * (D+1), B] in emission order; no host sync."""
        model = self.params
        D, last = self.draft_depth, self.max_seq - 1
        n = D + 1
        B = cur_tok.shape[0]
        ar = torch.arange(n, device=pos.device)

        def pick(logits, keys_at, reps=1):
            """Tokens from logits [rows, V]: argmax, or ``sample_token``
            with the slots' rows repeated ``reps`` times."""
            if sampling is None:
                return logits.argmax(-1)
            skey, temp, topk, topp = sampling
            if reps > 1:
                skey, temp, topk, topp = (x.repeat_interleave(reps, 0)
                                          for x in sampling)
            return smp.sample_token(smp.step_keys(skey, keys_at), logits,
                                    temp, topk, topp)

        toks, emitted = [], []
        for _ in range(self.sync_every):
            drafts = self._draft(pool, cur_tok, pos, pick)
            chunk = torch.cat([cur_tok, torch.stack(drafts, 1)], 1)
            logits, _ = model.decode_chunk(chunk, pool, pos)     # [B, n, V]
            posm = pos[:, None] + 1 + ar
            full = pick(logits.reshape(B * n, -1), posm.reshape(-1),
                        reps=n).reshape(B, n)
            tokc, posc, remc, actc = cur_tok[:, 0], pos, remaining, active
            ok = torch.ones_like(active)
            for j in range(n):
                cand = full[:, j]
                if j:
                    ok = (ok & (drafts[j - 1] == full[:, j - 1])
                          & (j <= depth_cap))
                emit = actc & ok
                new_pos = torch.where(emit, posc + 1, posc)
                new_rem = torch.where(emit, remc - 1, remc)
                retire = emit & ((new_rem <= 0) | (new_pos >= last)
                                 | (cand == eos))
                tokc = torch.where(emit, cand, tokc)
                posc, remc = new_pos, new_rem
                actc = actc & ~retire
                toks.append(cand)
                emitted.append(emit)
            cur_tok, pos, remaining, active = tokc[:, None], posc, remc, actc
        return (cur_tok, pos, active, remaining, torch.stack(toks),
                torch.stack(emitted))

    def _draft(self, pool, cur_tok, pos, pick) -> list[torch.Tensor]:
        """The macro-step's D draft tokens, [B] each: D decode steps of
        the draft prefix from ``pos``, on the pool's own rows as if on
        the reference's scratch copy of them (``continuous.py:451-470``).
        The steps write with the decode step's ring wrap, so a draft past
        the cache's last row reads what the reference's reads; the rows
        they write (``(pos + j) % C``, j < D, in the draft's layers) are
        saved before and put back after, so the verify finds the pool as
        the reference's does.  No host sync: it runs inside the captured
        window."""
        dl = self.cfg.draft_layers
        C = pool.k.shape[2]
        B = cur_tok.shape[0]
        b = torch.arange(B, device=pos.device)[:, None]
        rows = (pos[:, None] + torch.arange(self.draft_depth,
                                            device=pos.device)) % C
        leaves = (pool.k, pool.v, pool.pos)
        saved = [t[:dl, b, rows] for t in leaves]
        dtok, dpos, drafts = cur_tok, pos, []
        for _ in range(self.draft_depth):
            lg, _ = self.draft.decode_step(dtok, pool, dpos)
            t = pick(lg[:, 0], dpos + 1)
            drafts.append(t)
            dtok, dpos = t[:, None], dpos + 1
        for t, old in zip(leaves, saved):
            t[:dl, b, rows] = old
        return drafts

    # -- admission ----------------------------------------------------------
    def _admit(self, requests: list[GenRequest]) -> list[GenRequest]:
        """Run the controller over the stream, each request decided at
        its own arrival time when it has one."""
        queue: list[GenRequest] = []
        t = 0.0
        for r in requests:
            if self.controller is not None:
                ta = (float(r.arrival_t) if r.arrival_t is not None
                      else t)
                d = self.controller.decide(r.entropy_hint, ta)
                r.admitted = d.admit
                t = ta + 0.001
            if r.admitted:
                queue.append(r)
            else:
                r.done = True                 # skipped (proxy/cache)
        return queue

    def sampling_of(self, r: GenRequest) -> SamplingParams:
        return r.sampling if r.sampling is not None else self.default_sampling

    # -- serving ------------------------------------------------------------
    def start_session(self, prompt_len: int | None = None, *,
                      tracer: Tracer = NULL_TRACER) -> "DecodeSession":
        return DecodeSession(self, prompt_len=prompt_len, tracer=tracer)

    def serve(self, requests: list[GenRequest], *,
              prompt_len: int | None = None, legacy: bool = False) -> dict:
        """Run all requests to completion; returns summary stats.
        Prompts are padded/truncated to one prefill length.
        ``legacy=True`` runs the reference's per-step host loop (the
        parity baseline)."""
        wall0 = time.perf_counter()
        if legacy and self.paged:
            raise ValueError(
                "legacy=True serves the contiguous layout only; the "
                "paged pool's parity oracle is a contiguous engine "
                "(cfg.kv_block_size == 0)")
        queue = self._admit(list(requests))
        plen = prompt_len or max((len(r.prompt) for r in queue), default=8)
        if legacy:
            stats = self._serve_legacy(queue, plen)
        else:
            session = self.start_session(plen)
            for r in queue:
                session.push(r)
            while not session.idle:
                session.advance()
            stats = session.stats()
        wall = time.perf_counter() - wall0
        stats.update(
            n_requests=len(requests),
            n_admitted=sum(r.admitted for r in requests),
            tokens_generated=sum(len(r.generated) for r in requests),
            wall_s=wall,
        )
        return stats

    @torch.no_grad()
    def _serve_legacy(self, queue: list[GenRequest], plen: int) -> dict:
        """The reference's per-step loop (``continuous.py:774-893``): a
        batch-1 prefill written into its slot per refill, then per step
        one decode over every slot, a host copy of the sampled tokens
        and a per-slot Python loop.  Sampling is the window's rule on
        the same (rid, position)-folded keys."""
        B, dev, model = self.n_slots, self.device, self.params
        pool = self.init_cache(B)
        slots: list[GenRequest | None] = [None] * B
        pos = np.zeros(B, np.int64)
        cur_tok = np.zeros((B, 1), np.int64)
        active = np.zeros(B, bool)
        skey = np.zeros((B, 2), np.int64)
        temp = np.zeros(B, np.float32)
        topk = np.zeros(B, np.int64)
        topp = np.ones(B, np.float32)
        steps = occupied_slot_steps = prefills = 0
        device_s = 0.0

        def sample(logits, rows, at):
            """The tokens of slots ``rows`` written at positions ``at``."""
            keys, t, k, p = (torch.tensor(x[rows], device=dev)
                             for x in (skey, temp, topk, topp))
            keys = smp.step_keys(keys, torch.tensor(at, device=dev))
            return smp.sample_token(keys, logits, t, k, p).cpu().numpy()

        def refill():
            nonlocal prefills, device_s
            s = 0
            while s < B:
                if active[s] or not queue:
                    s += 1
                    continue
                r = queue.pop(0)
                p = np.zeros((1, plen), np.int64)
                p[0, :min(len(r.prompt), plen)] = r.prompt[:plen]
                t0 = time.perf_counter()
                logits, rows = model.prefill(torch.from_numpy(p).to(dev),
                                             self.init_cache(1))
                slot_write(pool, rows, np.array([s]))
                synchronize(dev)
                device_s += time.perf_counter() - t0
                prefills += 1
                sp = self.sampling_of(r)
                skey[s] = smp.request_key(sp.seed, r.rid)
                temp[s], topk[s], topp[s] = sp.temperature, sp.top_k, sp.top_p
                first = int(sample(logits[:, -1], [s], [plen])[0])
                r.generated.append(first)
                if r.eos_id is not None and first == r.eos_id:
                    r.done = True        # EOS at prefill: the slot stays
                    continue             # free for the next request
                slots[s] = r
                pos[s] = plen
                cur_tok[s, 0] = first
                active[s] = True
                s += 1

        refill()
        while active.any():
            steps += 1
            occupied_slot_steps += int(active.sum())
            t0 = time.perf_counter()
            logits, pool = model.decode_step(
                torch.tensor(cur_tok, device=dev), pool,
                torch.tensor(pos, device=dev))
            synchronize(dev)
            device_s += time.perf_counter() - t0
            nxt = sample(logits[:, 0], slice(None), pos + 1)
            for s in range(B):
                if not active[s]:
                    continue
                r = slots[s]
                r.generated.append(int(nxt[s]))
                pos[s] += 1
                cur_tok[s, 0] = nxt[s]
                if (len(r.generated) >= r.max_new
                        or pos[s] >= self.max_seq - 1
                        or (r.eos_id is not None
                            and int(nxt[s]) == r.eos_id)):
                    r.done = True
                    active[s] = False
                    slots[s] = None
            refill()
        return {
            "mode": "legacy",
            "sync_every": 1,
            "decode_steps": steps,
            "occupied_slot_steps": occupied_slot_steps,
            "occupancy": (occupied_slot_steps / (steps * B)
                          if steps else 0.0),
            "host_syncs": steps,
            "prefill_calls": prefills,
            "device_s": device_s,
        }


# ---------------------------------------------------------------------------
# incremental session — what the serving adapter drives
# ---------------------------------------------------------------------------

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def _traced(tracer: Tracer, name: str, parent):
    s = tracer.begin(name, parent=parent)
    try:
        yield s
    finally:
        tracer.end(s)


def _phase(tracer: Tracer, name: str, parent):
    """A span named ``name`` under ``parent`` around a with-block (bound
    to the span), or nothing where ``parent`` is None: tracing is off."""
    return _NO_SPAN if parent is None else _traced(tracer, name, parent)


def _describe_wave(span, reqs: list[GenRequest], rows: int, plen: int) -> None:
    """A refill span's attributes: the wave's requests, the prefill's
    rows (padding rows too), the padded length, and the prompt tokens
    real and as prefilled."""
    if span is not None:
        span.attrs.update(
            rids=[r.rid for r in reqs], rows=rows, plen=plen,
            prompt_tokens=sum(min(len(r.prompt), plen) for r in reqs),
            padded_tokens=rows * plen)


class DecodeSession:
    """One slot-pool decode session.  ``push`` enqueues at any time;
    ``advance`` refills free slots with one prefill, runs one
    ``sync_every``-step window, and returns the requests that completed
    in it.  All decode state between windows lives on the device, in
    tensors that keep their storage for the session's life (what a
    CUDA graph of the window reads and writes)."""

    def __init__(self, engine: ContinuousBatchingEngine,
                 prompt_len: int | None = None, *,
                 tracer: Tracer = NULL_TRACER):
        self.engine = engine
        self.prompt_len = prompt_len
        self.tracer = tracer
        self._span = None               # the open decode.advance span
        B, dev = engine.n_slots, engine.device
        self.queue: list[GenRequest] = []
        self.slots: list[GenRequest | None] = [None] * B
        self._pool = engine.init_cache(B)
        self._cur_tok = torch.zeros(B, 1, dtype=torch.long, device=dev)
        self._pos = torch.zeros(B, dtype=torch.long, device=dev)
        self._active = torch.zeros(B, dtype=torch.bool, device=dev)
        self._remaining = torch.zeros(B, dtype=torch.long, device=dev)
        self._eos = torch.full((B,), -1, dtype=torch.long, device=dev)
        # per-slot sampling rows, set at seating.  Keys derive from the
        # REQUEST id, never the slot index, so a reused slot never
        # replays its previous occupant's stream; the host keeps the
        # temperatures to pick the window's kind
        self._skey = torch.zeros(B, 2, dtype=torch.long, device=dev)
        self._temp = torch.zeros(B, dtype=torch.float32, device=dev)
        self._topk = torch.zeros(B, dtype=torch.long, device=dev)
        self._topp = torch.ones(B, dtype=torch.float32, device=dev)
        self._temp_h = np.zeros(B, np.float32)
        # the live speculative depth, written before each window: a
        # device scalar the captured window reads, so it moves with no
        # new capture
        self._depth_cap = torch.zeros((), dtype=torch.long, device=dev)
        # the window's tokens, emission masks and live flags, [2m+1, B]
        # with m = k steps, or k * (D+1) emissions of k macro-steps: the
        # one copy the host reads per window
        self._emissions = engine.sync_every * (engine.draft_depth + 1)
        self._packed = torch.zeros(2 * self._emissions + 1, B,
                                   dtype=torch.long, device=dev)
        self._graphs: dict[str, CountedGraph] = {}
        self._active_host = np.zeros(B, bool)
        self._prefill_done: list[GenRequest] = []
        # the disaggregated hand-off: externally prefilled requests
        # waiting for a slot, each (request, rows, first token, plen)
        self._insert_q: list[tuple] = []
        # paged pool: the host-side block allocator; the device sees only
        # the table it is handed.  Block 0 is the trash block.
        if engine.paged:
            self._free_blocks = list(range(1, engine.pool_blocks))
            self._slot_blocks: dict[int, list[int]] = {}
            self._table_h = np.zeros((B, engine.blocks_per_slot), np.int32)
            self._table_dirty = False
        self.blocks_allocated = 0
        self.blocks_freed = 0
        self.peak_blocks_in_use = 0
        self.decode_steps = 0
        self.occupied_slot_steps = 0
        self.host_syncs = 0
        self.prefill_calls = 0
        self.insert_calls = 0
        self.device_s = 0.0             # prefills + windows, host clock
        self.prefill_s = 0.0            # of which prefills
        self.issue_s = 0.0              # of the windows': issuing them
        self.capture_s = 0.0            # of which capturing graphs
        self.window_sync_s = 0.0        # of the windows': the host sync
        self.harvest_s = 0.0            # after the sync, to advance's return
        # between an advance's return, with slots active, and the next
        # advance: the caller's own loop
        self.caller_s = 0.0
        self._t_return = None
        self.captures = 0
        # speculative decode telemetry
        self.spec_proposed = 0          # drafted tokens offered to verify
        self.spec_accepted = 0          # drafts the full model confirmed
        self.spec_draft_slot_steps = 0  # shallow passes (energy model)
        self.last_depth = engine.draft_depth
        self.work = {phase: dict.fromkeys(WORK, 0)
                     for phase in ("prefill", "decode")}
        self._window_work = window_work(engine)

    # -- state --------------------------------------------------------------
    @property
    def idle(self) -> bool:
        return (not self.queue and not self._insert_q
                and not self._active_host.any())

    @property
    def n_active(self) -> int:
        return int(self._active_host.sum())

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    def push(self, r: GenRequest) -> None:
        self.queue.append(r)

    @torch.no_grad()
    def warm(self) -> "DecodeSession":
        """Capture the window of every kind now, while the session is
        idle, so that no later ``advance`` pays for a first window or a
        capture: a session made for a timed line (a disaggregated decode
        worker's, a crashed worker's new one, an adapter's) is set up
        before its clock starts.  Each warm window runs over slots none
        of which is active, as every window runs its free slots, and
        seating overwrites what it leaves.  An engine that does not
        capture (the CPU) has nothing to set up.  -> the session."""
        eng = self.engine
        if eng.graphed:
            self._depth_cap.fill_(eng.draft_depth)
            for kind in eng.decode_captures:
                if kind not in self._graphs:
                    self._run_window(kind)
        return self

    # -- disaggregated insert -----------------------------------------------
    def insert_prefilled(self, r: GenRequest, rows: tfm.Cache, first: int,
                         plen: int) -> None:
        """Accept an EXTERNALLY prefilled request: ``rows`` a batch-1
        contiguous row cache holding the prompt's KV (at least ``plen``
        rows; on a paged pool, the prompt's block multiple), ``first``
        the token the prefill emitted, ``plen`` the padded prompt length
        the rows were built at.  The request is seated on the next
        ``advance``, or waits in FIFO order while no slot is free."""
        self._insert_q.append((r, rows, first, plen))

    @torch.no_grad()
    def _drain_inserts(self) -> None:
        """Seat queued inserts into free slots (ref
        ``continuous.py:1012-1092``).  FIFO: the head waits while no slot
        (paged: not enough blocks for its whole budget) is free; EOS
        straight out of prefill completes on the host."""
        eng = self.engine
        B, dev = eng.n_slots, eng.device
        bs = eng.cfg.kv_block_size if eng.paged else 0
        while self._insert_q:
            r, rows, first, plen = self._insert_q[0]
            if r.eos_id is not None and first == r.eos_id:
                # EOS straight out of prefill: the pool is never touched
                self._insert_q.pop(0)
                r.generated.append(int(first))
                r.done = True
                self._prefill_done.append(r)
                continue
            free = [s for s in range(B) if not self._active_host[s]]
            if not free:
                return                       # every slot busy: wait
            s = free[0]
            if eng.paged:
                allocatable = eng.pool_blocks - 1
                need = blocks_for_request(plen, r.max_new, eng.max_seq, bs)
                if need > allocatable:
                    raise ValueError(
                        f"request rid={r.rid} needs {need} KV blocks "
                        f"(prompt {plen} + max_new {r.max_new} rows at "
                        f"block_size {bs}) but the pool has only "
                        f"{allocatable} allocatable blocks — it can "
                        f"never be inserted; raise kv_pool_blocks or "
                        f"shrink the request budget")
                if need > len(self._free_blocks):
                    return                   # pool exhausted: wait
                assigned = [self._free_blocks.pop() for _ in range(need)]
                table_row = np.zeros(eng.blocks_per_slot, np.int32)
                table_row[:need] = assigned
                self.blocks_allocated += need
                self.peak_blocks_in_use = max(
                    self.peak_blocks_in_use,
                    allocatable - len(self._free_blocks))
            self._insert_q.pop(0)
            t0 = time.perf_counter()
            if eng.paged:
                paged_slot_write(self._pool, rows, np.array([s]),
                                 table_row[None], block_size=bs,
                                 n_pref_blocks=-(-plen // bs))
                self._table_h[s] = table_row
                self._slot_blocks[s] = assigned
                self._table_dirty = True
            else:
                slot_write(self._pool, rows, np.array([s]))
            sampling = self._sampling_rows([r])
            self._set_slots(
                [s], torch.tensor([first], device=dev), plen,
                [max(r.max_new - 1, 1)],
                [-1 if r.eos_id is None else int(r.eos_id)],
                [torch.as_tensor(x, device=dev) for x in sampling],
                sampling[1])
            synchronize(dev)
            self.device_s += time.perf_counter() - t0
            self.insert_calls += 1
            r.generated.append(int(first))
            r.slot = s
            self.slots[s] = r
            self._active_host[s] = True

    # -- refill -------------------------------------------------------------
    @torch.no_grad()
    def _refill(self) -> None:
        free = [s for s in range(self.engine.n_slots)
                if not self._active_host[s]]
        take = min(len(free), len(self.queue))
        if take == 0:
            return
        # the span's self time is the host's planning: the queue, the
        # wave's arrays and the prompt tokens' copy to the device
        with _phase(self.tracer, "decode.refill", self._span) as span:
            if self.engine.paged:
                self._refill_paged(free, take, span)
            else:
                self._refill_contiguous(free, take, span)

    def _refill_contiguous(self, free: list[int], take: int, span) -> None:
        eng, tr = self.engine, self.tracer
        B, dev = eng.n_slots, eng.device
        reqs = [self.queue.pop(0) for _ in range(take)]
        # the reference's prompt-length rule: a fixed prompt_len, else the
        # wave's longest prompt rounded up to a bucket
        plen = self.prompt_len or min(
            _bucket(max(max(len(r.prompt) for r in reqs), 1)),
            eng.max_seq - 1)
        nb = eng.prefill_rows(take)
        _describe_wave(span, reqs, nb, plen)
        toks, rem_new, eos_new = _wave_arrays(reqs, plen, nb)
        slot_idx = np.asarray(free[:take])
        t0 = time.perf_counter()
        with _phase(tr, "decode.refill.alloc", span):
            rows = eng.init_cache(nb)
        toks_d = torch.from_numpy(toks).to(dev)
        with _phase(tr, "decode.refill.prefill", span):
            logits, rows = eng.params.prefill(toks_d, rows)
        _add_work(self.work["prefill"], tfm.step_work(eng.cfg, nb, plen))
        # padding rows go to slot B, out of range: not written
        with _phase(tr, "decode.refill.scatter", span):
            slot_write(self._pool, rows, np.pad(slot_idx, (0, nb - take),
                                                constant_values=B))
        with _phase(tr, "decode.refill.first", span):
            first_h = self._start_slots(logits[:take], slot_idx, plen,
                                        rem_new, eos_new, reqs)
        dt = time.perf_counter() - t0
        self.device_s += dt
        self.prefill_s += dt
        self.prefill_calls += 1
        self._seat_prefilled(reqs, slot_idx, first_h)

    def _sampling_rows(self, reqs):
        """One wave's sampling rows (ref ``continuous.py:985``): request
        keys, temperatures, top-k, top-p."""
        sps = [self.engine.sampling_of(r) for r in reqs]
        return (np.stack([smp.request_key(sp.seed, r.rid).astype(np.int64)
                          for sp, r in zip(sps, reqs)]),
                np.array([sp.temperature for sp in sps], np.float32),
                np.array([sp.top_k for sp in sps], np.int64),
                np.array([sp.top_p for sp in sps], np.float32))

    def _start_slots(self, logits, slot_idx, plen, rem_new, eos_new, reqs):
        """The prefill's first tokens, sampled with ``step_keys(skey,
        plen)`` as the reference's prefill does (``continuous.py:579,
        622``), and the seated slots' decode and sampling state, written
        in place on the device; -> the first tokens on the host."""
        dev = self.engine.device
        rows = self._sampling_rows(reqs)
        rows_d = [torch.as_tensor(x, device=dev) for x in rows]
        first = first_tokens(logits[:, -1], plen, rows_d,
                             bool((rows[1] > 0).any()))
        self._set_slots(slot_idx, first, plen, rem_new, eos_new, rows_d,
                        rows[1])
        return first.cpu().numpy()

    def _set_slots(self, slot_idx, first, plen, rem_new, eos_new, rows_d,
                   temp_h) -> None:
        """Slots ``slot_idx``' decode state from their first tokens
        ``first`` (on the device) and their sampling rows ``rows_d``,
        each an indexed write into the session's own tensors (what a
        captured window reads), never a rebinding."""
        dev = self.engine.device
        idx = torch.as_tensor(slot_idx, device=dev)
        eos_t = torch.as_tensor(eos_new, device=dev)
        self._cur_tok[idx, 0] = first
        self._pos[idx] = plen
        # a slot whose PREFILL token already hits EOS never decodes
        self._active[idx] = first != eos_t
        self._remaining[idx] = torch.as_tensor(rem_new, device=dev)
        self._eos[idx] = eos_t
        for buf, x in zip((self._skey, self._temp, self._topk, self._topp),
                          rows_d):
            buf[idx] = x
        self._temp_h[slot_idx] = temp_h

    def _seat_prefilled(self, reqs, slots_for, first_h, *,
                        on_prefill_eos=None) -> None:
        """Append each request's first token and seat it in its slot —
        or, when that token IS its EOS, complete it straight away
        (``on_prefill_eos`` lets the paged layout free its blocks)."""
        for j, r in enumerate(reqs):
            s = int(slots_for[j])
            r.generated.append(int(first_h[j]))
            if r.eos_id is not None and first_h[j] == r.eos_id:
                r.done = True            # EOS straight out of prefill
                self._prefill_done.append(r)
                if on_prefill_eos is not None:
                    on_prefill_eos(s)
                continue
            r.slot = s
            self.slots[s] = r
            self._active_host[s] = True

    def _free_slot_blocks(self, s: int) -> None:
        """Return slot ``s``'s blocks to the pool and point its table row
        at the trash block (copied to the device before the next
        window)."""
        blocks = self._slot_blocks.pop(s, [])
        self._free_blocks.extend(blocks)
        self.blocks_freed += len(blocks)
        self._table_h[s] = 0
        self._table_dirty = True

    def _refill_paged(self, free: list[int], take: int, span) -> None:
        """Paged refill (ref ``continuous.py:1174-1270``): reserve each
        request's WHOLE block budget before seating it.  FIFO: the head
        waits while the pool cannot cover its budget.  The wave, and its
        shared padded prompt length, is decided first without touching
        the pool; blocks are popped only once it is final, so the
        can-never-be-served error leaves the state clean.  The wave's
        plen grows only with the members actually taken, so a long
        prompt deeper in the queue never inflates an earlier request's
        budget (that error is judged at the request's own padding)."""
        eng, tr = self.engine, self.tracer
        dev = eng.device
        bs = eng.cfg.kv_block_size
        allocatable = eng.pool_blocks - 1           # block 0 = trash
        wave: list[GenRequest] = []
        needs: list[int] = []
        plen_wave = self.prompt_len or 0
        for r in self.queue[:take]:
            solo_plen = self.prompt_len or min(
                _bucket(max(len(r.prompt), 1)), eng.max_seq - 1)
            solo_need = blocks_for_request(solo_plen, r.max_new,
                                           eng.max_seq, bs)
            if solo_need > allocatable:
                raise ValueError(
                    f"request rid={r.rid} needs {solo_need} KV blocks "
                    f"(prompt {solo_plen} + max_new {r.max_new} rows "
                    f"at block_size {bs}) but the pool has only "
                    f"{allocatable} allocatable blocks — it can never "
                    f"be served; raise kv_pool_blocks or shrink the "
                    f"request budget")
            new_plen = max(plen_wave, solo_plen)
            # a longer prompt re-pads the whole wave: re-budget every
            # member at the grown plen before committing to it
            new_needs = [blocks_for_request(new_plen, x.max_new,
                                            eng.max_seq, bs)
                         for x in (*wave, r)]
            if sum(new_needs) > len(self._free_blocks):
                break                    # pool exhausted: the head waits
            wave.append(r)
            needs = new_needs
            plen_wave = new_plen
        if not wave:
            return
        plen = plen_wave
        assigned = [[self._free_blocks.pop() for _ in range(n)]
                    for n in needs]
        reqs = [self.queue.pop(0) for _ in wave]
        n, npb = len(reqs), -(-plen // bs)
        nb = eng.prefill_rows(n)
        _describe_wave(span, reqs, nb, plen)
        toks, rem_new, eos_new = _wave_arrays(reqs, plen, nb)
        # padding rows' entries and slots are out of range: not written
        table_rows = np.full((nb, eng.blocks_per_slot), eng.pool_blocks,
                             np.int32)
        table_rows[:n] = 0
        for j, blocks in enumerate(assigned):        # trash-padded
            table_rows[j, :len(blocks)] = blocks
        slot_idx = np.asarray(free[:n])
        self.blocks_allocated += sum(needs)
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      allocatable - len(self._free_blocks))
        t0 = time.perf_counter()
        with _phase(tr, "decode.refill.alloc", span):
            rows = eng.init_cache(nb, npb * bs, layout="contiguous")
        toks_d = torch.from_numpy(toks).to(dev)
        with _phase(tr, "decode.refill.prefill", span):
            logits, rows = eng.params.prefill(toks_d, rows)
        _add_work(self.work["prefill"], tfm.step_work(eng.cfg, nb, plen))
        with _phase(tr, "decode.refill.scatter", span):
            paged_slot_write(self._pool, rows,
                             np.pad(slot_idx, (0, nb - n),
                                    constant_values=eng.n_slots),
                             table_rows, block_size=bs, n_pref_blocks=npb)
        with _phase(tr, "decode.refill.first", span):
            first_h = self._start_slots(logits[:n], slot_idx, plen, rem_new,
                                        eos_new, reqs)
        dt = time.perf_counter() - t0
        self.device_s += dt
        self.prefill_s += dt
        self.prefill_calls += 1
        for j, s in enumerate(slot_idx):
            self._table_h[s] = table_rows[j]
            self._slot_blocks[int(s)] = assigned[j]
        self._seat_prefilled(reqs, slot_idx, first_h,
                             on_prefill_eos=self._free_slot_blocks)

    # -- advance ------------------------------------------------------------
    def advance(self) -> list[GenRequest]:
        """Refill free slots, run one ``sync_every``-step window,
        harvest.  Returns the requests COMPLETED by this window."""
        t_in = time.perf_counter()
        if self._t_return is not None:
            self.caller_s += t_in - self._t_return
        tr = self.tracer
        if tr.enabled:
            self._span = tr.begin("decode.advance", active=self.n_active,
                                  queued=self.n_queued)
        try:
            return self._advance()
        finally:
            if self._span is not None:
                tr.end(self._span)
                self._span = None
            self._t_return = (time.perf_counter()
                              if self._active_host.any() else None)

    def _advance(self) -> list[GenRequest]:
        eng, tr, root = self.engine, self.tracer, self._span
        if self._insert_q:
            # a span only for a drain that seats a request
            seated = self.insert_calls
            t = tr.clock.now() if root is not None else None
            self._drain_inserts()
            if root is not None and self.insert_calls > seated:
                tr.span("decode.insert", t, tr.clock.now(), parent=root,
                        seated=self.insert_calls - seated)
        self._refill()
        done_at_prefill, self._prefill_done = self._prefill_done, []
        if not self._active_host.any():
            return done_at_prefill
        if eng.paged and self._table_dirty:
            # retired slots' rows now point at the trash block: a freed,
            # maybe reallocated, block is never written by its old slot
            self._pool.block_table.copy_(torch.from_numpy(self._table_h))
            self._table_dirty = False
        # the window's kind, from the seated slots' temperatures (the
        # reference's lax.cond, decided on the host)
        kind = ("sampled" if (self._temp_h[self._active_host] > 0).any()
                else "greedy")
        depth = eng.current_depth() if eng.draft_depth > 0 else 0
        if depth:
            self.last_depth = depth
            self._depth_cap.fill_(depth)
        t0 = time.perf_counter()
        with _phase(tr, "decode.window.issue", root):
            self._run_window(kind)
        t1 = time.perf_counter()
        # ONE host sync per window: tokens, emission masks and live flags
        # come back in a single copy
        with _phase(tr, "decode.window.sync", root):
            packed = self._packed.cpu().numpy()
        t2 = time.perf_counter()
        self.device_s += t2 - t0
        self.issue_s += t1 - t0
        self.window_sync_s += t2 - t1
        with _phase(tr, "decode.harvest", root):
            completed = self._harvest(packed, done_at_prefill, depth)
        self.harvest_s += time.perf_counter() - t2
        return completed

    def _harvest(self, packed: np.ndarray, done_at_prefill: list,
                 depth: int) -> list[GenRequest]:
        """The window's copy read back into the slots and the counters:
        each seated request's new tokens, and the requests that finished
        (the slot freed, and on a paged pool its blocks)."""
        eng = self.engine
        m = self._emissions
        toks_h = packed[:m]                   # chronological
        emit_h = packed[m:2 * m].astype(bool)
        active_h = packed[2 * m].astype(bool)
        self.host_syncs += 1
        # (macro-)slot accounting (ref continuous.py:1306-1322): emission 0
        # of a step marks the slots live for it (one full pass each); a
        # macro-step's emissions 1.. are its accepted drafts
        emit3 = emit_h.reshape(eng.sync_every, eng.draft_depth + 1, -1)
        live = emit3[:, 0, :]
        self.decode_steps += int(live.any(axis=1).sum())
        self.occupied_slot_steps += int(live.sum())
        if eng.draft_depth > 0:
            accepted = int(emit3[:, 1:, :].sum())
            proposed = int(live.sum()) * depth
            self.spec_accepted += accepted
            self.spec_proposed += proposed
            self.spec_draft_slot_steps += proposed
            if eng.spec_controller is not None:
                eng.spec_controller.observe(accepted=accepted,
                                            proposed=proposed)
        completed: list[GenRequest] = list(done_at_prefill)
        for s in range(eng.n_slots):
            r = self.slots[s]
            if r is None:
                continue
            r.generated.extend(int(x) for x in toks_h[emit_h[:, s], s])
            if not active_h[s]:
                r.done = True
                completed.append(r)
                self.slots[s] = None
                if eng.paged:
                    self._free_slot_blocks(s)
        self._active_host = active_h
        return completed

    @torch.no_grad()
    def _window(self, kind: str) -> None:
        """One window over the session's own tensors: ``step_window``,
        then its results written back into them in place."""
        eng = self.engine
        sampling = ((self._skey, self._temp, self._topk, self._topp)
                    if kind == "sampled" else None)
        state = (self._pool, self._cur_tok, self._pos, self._active,
                 self._remaining, self._eos)
        if eng.draft_depth > 0:
            cur, pos, act, rem, toks, emitted = eng.step_window_spec(
                *state, self._depth_cap, sampling)
        else:
            cur, pos, act, rem, toks, emitted = eng.step_window(*state,
                                                                sampling)
        self._cur_tok.copy_(cur)
        self._pos.copy_(pos)
        self._active.copy_(act)
        self._remaining.copy_(rem)
        torch.cat([toks, emitted.long(), act[None].long()], out=self._packed)

    def _run_window(self, kind: str) -> None:
        """Run one window: uncaptured unless the engine is graphed, else
        by replaying this kind's graph.  The first window of a kind runs
        outside capture on the engine's side stream (every kernel built
        and warmed, cuBLAS's handles and workspaces made), and is then
        captured for the windows after it.  A failed capture or replay
        raises."""
        eng = self.engine
        _add_work(self.work["decode"], self._window_work)
        if not eng.graphed:
            self._window(kind)
            return
        graph = self._graphs.get(kind)
        if graph is not None:
            graph.replay()
            return
        main = torch.cuda.current_stream(eng.device)
        side = eng.side_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._window(kind)
        main.wait_stream(side)
        graph = CountedGraph()
        t0 = time.perf_counter()
        graph.capture(lambda: self._window(kind))
        self.capture_s += time.perf_counter() - t0
        self._graphs[kind] = graph
        self.captures += 1
        eng.decode_captures[kind] += 1

    # -- reporting ----------------------------------------------------------
    def stats(self) -> dict:
        eng = self.engine
        B = eng.n_slots
        out = {
            "mode": "paged" if eng.paged else "fused",
            "sync_every": eng.sync_every,
            "decode_steps": self.decode_steps,
            "occupied_slot_steps": self.occupied_slot_steps,
            "occupancy": (self.occupied_slot_steps
                          / (self.decode_steps * B)
                          if self.decode_steps else 0.0),
            "host_syncs": self.host_syncs,
            "prefill_calls": self.prefill_calls,
            "insert_calls": self.insert_calls,
            "device_s": self.device_s,
            "prefill_s": self.prefill_s,
            "window": "graph" if eng.graphed else "eager",
            "window_issue_s": self.issue_s,
            "window_sync_s": self.window_sync_s,
            "harvest_s": self.harvest_s,
            "caller_s": self.caller_s,
            "capture_s": self.capture_s,
            "captures": self.captures,
        }
        if eng.paged:
            out.update(
                kv_block_size=eng.cfg.kv_block_size,
                pool_blocks=eng.pool_blocks,
                blocks_allocated=self.blocks_allocated,
                blocks_freed=self.blocks_freed,
                peak_blocks_in_use=self.peak_blocks_in_use,
                free_blocks=len(self._free_blocks))
        if eng.draft_depth > 0:
            # ref continuous.py:1369-1389.  The modelled energy charges
            # one unit per full-stack slot pass and draft_layers/n_layers
            # per shallow pass at the LIVE depth, over tokens emitted
            # (greedy decode is exactly 1.0 on this scale); the window
            # itself runs all draft_depth drafts whatever the live depth
            emitted = self.occupied_slot_steps + self.spec_accepted
            c = eng.cfg.draft_layers / eng.cfg.n_layers
            cost = (self.occupied_slot_steps
                    + self.spec_draft_slot_steps * c)
            out.update(
                mode="spec",
                draft_depth=eng.draft_depth,
                draft_depth_live=self.last_depth,
                draft_layers=eng.cfg.draft_layers,
                spec_proposed=self.spec_proposed,
                spec_accepted=self.spec_accepted,
                acceptance_rate=(self.spec_accepted
                                 / max(self.spec_proposed, 1)),
                accepted_per_step=(emitted
                                   / max(self.occupied_slot_steps, 1)),
                energy_per_token_model=(cost / max(emitted, 1)))
        return out
