"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --decode-graph   # sampling_keys, decode_graph only
    python3 chip_smoke.py --fleet          # train_classifier, fleet only
    python3 chip_smoke.py --disagg         # the disagg phases only
    python3 chip_smoke.py --train          # the training phases only
    python3 chip_smoke.py --shard          # the sharding phases only
    python3 chip_smoke.py --attention      # attention kernels, hd-256 paths
    python3 chip_smoke.py --latent         # the MLA latent decode kernel

Drives ``src/repro_torch`` only (no JAX, nothing of ``repro``) and prints
one JSON object per line; any failed check raises, so the exit code is
not 0.  Phases:

  1. device  — the card's name, capability, power limit and idle power;
  2. build   — every CUDA kernel, built from ``src/repro_torch/kernels/csrc``
               (one ``nvcc`` per source, all at once), with the seconds taken
               in all and by each library, the count of ``HGMMA``
               (tensor-core ``wgmma``) instructions in the flash library's
               SASS, of ``HMMA`` / ``HGMMA`` in the SSD library's and of
               ``HMMA`` in the latent decode library's (``cuobjdump``);
  3. kernel  — first ``launch_floor``: the entropy library's empty kernel
               (one warp, no work), device and call time; then the entropy
               kernel on the card against its plain PyTorch version on the
               same inputs (f32 and bf16 to 1e-4, argmax exact, the first
               index winning ties, one launch counted per call), at the
               gated step's shapes and their edges (300 rows, V = 1), a
               warp-per-row width, proxy and vocabulary widths (odd V in
               f32 and bf16) and ties across slice boundaries; each row
               prints the schedule the wrapper chose (packed, warp, split
               with its splits); 8 x 256000 also from two streams at once
               (``kernel_two_streams``) and from two CUDA graphs replayed
               at once (``kernel_two_graphs``); timed with CUDA events
               beside its bound, the launch floor (``floor_ms``) and a
               one-call PyTorch yardstick: ``ms`` is device time (calls
               replayed from a CUDA graph), ``call_ms`` the time per call
               issued back to back from Python, and a split row's
               ``cold_ms`` device time on inputs that miss the L2;
  4. train_classifier — the launcher's ``build_classifier()`` on the card
               (the reference's 3-layer, d 64 DistilBERT, 150 steps of
               AdamW), timed; the same init trained on the CPU over the
               same batches; on the launcher's 2,000 requests the full and
               exit-1 logits' largest differences, each head's accuracy,
               and predictions that must agree on 99 % or more; the last
               ``ce`` must be below the first;
     serve   — the launcher's ``serve_classifier`` on ``--path gated`` (bio
               controller, batch 64) and on ``--path auto``, first on the
               trained default (trained within the run), then with
               ``--full-width`` (6 layers, d 768, seeded weights); each run
               with the launch counters zeroed just before and read just
               after, and must have launched every kernel of the path;
     system  — ``tests/test_system.py``'s claims on the card-trained
               classifier (its fixed latency models, ``ClosedLoopSimulator``,
               the proxy after 2 layers): open admission 1.0 and bio below
               0.9, bio's busy time and energy below open's, an accuracy
               drop under 0.10, the full model at least as accurate as the
               proxy, mean entropy at difficulty 0.95 above that at 0.2;
               then ``table3_row``, printed only: bio and bio-adaptive
               (target 0.58) against open over 2,000 requests, latency
               models calibrated on the card (time and energy saving %,
               admission rate, accuracy drop);
     fleet   — the launcher's ``serve_fleet``: three live replicas
               (direct, dynamic-batch, gated-in-graph; energy-aware router,
               autoscaler, each replica's own bio controller; max batch 8)
               on the ``flash-crowd`` scenario, 600 requests, through the
               card-trained classifier and through the full-width
               DistilBERT (6 layers, d 768, seq 128, seeded); the
               ``crash-storm`` story (faults, bounded retry, brownout) on
               the trained classifier; the sim fleet's ``flash-crowd`` as a
               host-only baseline.  Each run writes its trace and metrics
               (validated), reads the card's energy counter through NVML
               around the run (``--energy-source nvml``: modelled joules,
               NVML joules, the window's seconds, the drift ratio, beside
               the card's draw at rest), and prints its routed counts,
               admission rate, p50/p95, busy and wall seconds,
               ``compile_seconds``, each replica's largest and median batch
               walltime, and the entropy kernel's launches (zeroed just
               before, read just after; > 0 in each live run); every
               request answered once, or rejected with a reason;
     resnet  — ResNet-18 (100 classes, 64 x 64, seed 1) through
               ``CallableEngineAdapter`` and ``Server`` on the direct path,
               100 requests; logits card vs CPU from the same weights in
               f32 within 1e-4 of the largest; ms per request beside the
               card's name and power limit;
  5. parity  — the proxy entropy from the kernel against the plain version,
               and full-model logits on the card against the CPU (1e-3);
  6. breakdown — the gated step's parts at batch 64, timed on the card;
  7. attention — the flash-attention, flash-decode and paged
               flash-decode kernels against their plain versions (f32 to
               1e-4; bf16 to 3e-2 and each row to 2^-6 of its largest
               output) at the generate path's shapes, long shapes (one
               user's 8192-row context among them), ragged and GQA +
               window cases, granite-moe-3b-a800m's G = 3 shapes (24
               query heads over 8 KV heads of 64: ``*_granite``, and
               ``decode_granite_backlog``, its decode-backlog cell's 128
               slots over 2048 rows, ~840 live), llama3's G = 16 at hd
               128 (``decode_llama3``; each decode row prints the body
               that ran and ``gqa_launches``), the
               smoke configuration's hd 32 and the disaggregated path's
               (``*_disagg*``: batch-1 prefills of 8 and 32 tokens, a
               decode worker's 8 slots over 64 rows, contiguous and
               paged), timed
               beside their bounds and ``scaled_dot_product_attention``
               with the same mask (a yardstick only: the port never calls
               it; for the paged kernel on the pre-gathered view, the
               gather left out); the paged kernel also against its gather
               shim, byte for byte; a decode call's spans and span-merge
               launches; then ``decode_invariance``: the serving case's
               valid rows in a 128-row and in a mostly empty 4096-row
               cache, contiguous and paged, all equal byte for byte, at
               stablelm's 32/32 heads of 80, granite's 24/8 of 64,
               llama3's 128/8 of 128, the smoke configuration's 16/4 of
               16 and recurrentgemma's 10/1 of 256;
     spec_chunk — the verify chunk's entry on the flash-decode body
               (``decode_attention_chunk_cuda``, n query rows per slot)
               against its plain version (f32 to 1e-4; bf16 to 3e-2 and
               each row to 2^-6 of its largest output) at the serving
               shape (8 slots x 4 queries x 32 heads, 128 rows, 17-31
               valid), a 4096-row cache (spans merged), ragged starts,
               a chunk written by ``cache_write_chunk`` whose last rows
               clamp onto the cache's last row, and granite's 24/8 heads
               of 64 (the GQA body) at 128 and 4096 rows; row j
               ``torch.equal`` to
               the single-query kernel at ``start + j``; timed beside its
               bound, the n single-query launches and SDPA with the
               [B, H, n, S] mask;
     sampling_keys — at 8 slots x the vocabulary: ``step_keys`` and the
               Gumbel bits on the card equal the port's numpy threefry bit
               for bit, the Gumbel floats within 2 eps of max(1, |g|) of
               float64 from the same bits (the CPU's float32 distance to
               it printed, and a ``sampling_keys_cpu_fault`` line, which
               fails nothing, where the CPU is past it); the cost of one
               sampled step by graph replay,
               part by part (keys, Gumbel noise, sort, masks), beside the
               greedy argmax;
     serve_generate_smoke — the launcher's ``--smoke`` generate run (hd
               32: bf16 on the flash kernel's CUDA-core body) on the card;
 8. serve_generate — stablelm-3b at published width (32 layers, bf16,
               seeded weights) through the launcher's ``serve_generate``:
               32 requests x 16 new tokens over 8 slots, bio controller;
               both attention kernels' launch counters zeroed just before
               and read just after, and both must have launched; the
               decode window one CUDA graph, captured once and replayed
               (replays counted in the launches), as in every served
               generate phase;
  9. parity_generate — published width at depth 2 in f32, prefill logits
               on the card (kernel path) against the CPU (einsum path)
               within 1e-3 and 8 greedy tokens equal; the served model at
               full depth in bf16, kernel path against ``attn_impl="xla"``;
 10. breakdown_generate — one decode step at 8 slots: attention kernels,
               products and the rest, beside the weight-bytes bound; and
               the same step over a paged pool (breakdown_generate_paged);
               prefill_long_generate — one 2048-token prompt through the
               served model into a 2064-row cache: ms per call, flash
               launches, flash's share of the call's device time, and the
               first 8 greedy tokens against ``attn_impl="xla"``;
 11. serve_generate_paged — the same launcher run on a paged pool of 13
               blocks of 16 rows (``--kv-block-size 16 --kv-pool-blocks
               13``: 12 allocatable blocks seat at most 6 of the 8 slots;
               at the launcher's arrivals, 1 ms apart with one window
               each, about 2 requests are in flight, so the wait for
               blocks is exercised by parity_paged); the paged kernel
               launched, the contiguous decode kernel not, every block
               given back;
 12. parity_paged — the served model on one trace (mixed prompt lengths
               and budgets, one EOS, a pool small enough that requests
               wait) through the paged engine and the contiguous engine
               fed the same prefill waves, no controller: the same
               tokens for every request;
 12b. decode_graph — stablelm-3b at full width, 8 slots, on the
               contiguous and on a paged pool (bs 16): 16 requests of 16 +
               16 tokens (two refill waves), greedy and sampled (T 0.8,
               top-k 50, top-p 0.95), uncaptured (``capture=False``) and
               captured: the same tokens, one capture per kind, decode
               launches = layers x steps in both (replays counted), and the
               steady windows' ms per step, issue ms and the card's busy
               share (one window replayed over the window's time); the
               same for mamba2-780m after phase 16;
     parity_spec — speculative against non-speculative tokens: published
               width at depth 2 in f32 with f32 caches (TF32 off, printed),
               D = 3 over a one-layer draft, greedy and sampled, aligned
               and seeded weights, 16 requests through the captured
               engines, equal for every request; the verify chunk's logits
               against sequential steps (largest difference over largest
               |logit|) at depth 2 and at full depth; the served model at
               full depth in bf16, lockstep greedy with a draft of 8
               layers: the token agreement, every first divergence a
               near-tie (top-2 gap and logit difference printed);
     decode_graph_spec — the speculative window at full width, 8 slots,
               draft of 8 layers, D = 3, 16 requests of 16 + 16 tokens,
               aligned weights (layers 8-31 the identity) and the seeded
               ones, greedy and sampled, uncaptured and captured: the same
               tokens, one capture per kind (the live depth moving in the
               aligned greedy session), decode launches = D x 8 x
               macro-steps and chunk launches = 32 x macro-steps (replays
               counted); ms per macro-step and per emitted token, the
               card's busy share, acceptance, the modelled energy per
               token, and the non-speculative captured step on the same
               weights;
     disagg  — the split-phase path (``repro_torch.disagg``):
               ``disagg_parity``: the served model through
               ``DisaggEngine`` (each prompt prefilled at batch 1 through
               the flash kernel, inserted, decoded in the captured
               window), 12 requests over 8 slots, contiguous and paged
               (bs 16): tokens byte-equal to a pooled session fed one
               request per wave (the same product shapes), the pooled
               session fed the whole queue printed beside it (agreement,
               first divergence), and insert-after-capture (8 requests
               inserted into a session whose windows are captured, their
               replayed tokens equal to an uncaptured engine's; every
               ``start_session`` captures both window kinds up front);
               ``disagg_parity_f32``: the reference test's trace (6
               requests over 3 slots) at depth 2 in f32, split on the
               card == pooled on the card == split on the CPU;
               ``disagg_chaos``: a decode crash plus a link flap over 2 +
               2 workers, every rid resolved once, the crashed worker's
               old session freed; ``disagg_live``: a live fleet of two
               ``generate`` replicas (``build_live_fleet``, each a
               ``DisaggEngineAdapter`` behind a ``Server``), 32 requests:
               each rid answered once, tokens equal to ``DisaggEngine``'s,
               flash and decode launched (``fleet_generate``); then the
               launcher's ``--fleet-disagg``
               at published width (48 requests, 2 prefill and 2 decode
               workers) on ``prompt-burst`` and ``long-decode`` and, on a
               paged pool, ``prompt-burst``: served and rejected, p50 and
               p95, each worker's busy seconds, transfers and bytes,
               prefill ms by prompt length and decode ms per window (from
               the trace), captures and their seconds, modelled beside
               NVML joules, the kernels' launches counted from after the
               fleet's build and warm-up (``serve.build_disagg``; the
               warm-up's printed apart), every decode session's captures
               made before its run (``--disagg`` runs this phase alone);
     serve_generate_spec — the launcher with ``--draft-depth 3
               --draft-layers 8`` on stablelm-3b: every request answered,
               the flash, decode and chunk kernels launched (this slice's
               main path: the counters zeroed just before, read just
               after), the window one captured graph;
     serve_generate_sampled — the launcher with ``--temperature 0.8
               --top-k 50 --top-p 0.95`` on stablelm-3b: every request
               answered, the window one captured graph;
 13. ssd     — the SSD scan kernel, both entry points (``ssd_scan``: zero
               state, y; ``ssd_chunked``: from h0, y and h_last), against
               their plain versions (the per-token recurrence; the chunked
               algorithm) at the serving prefill's shape, at S = 4096, at a
               ragged S = 1000, at the parity prompt (S = 300) and one row
               past a chunk (S = 65), from a zero and a nonzero h0, in f32
               and bf16, over both schedules (one chunk in one launch up to
               S = 64; chunk-parallel, three launches, 3xTF32 tensor-core
               products, beyond), timed beside its bound (bytes, or f32
               operations on the CUDA cores) and, for the chunk-parallel
               schedule, beside the 3xTF32 bound at the TF32 peak (no one
               PyTorch call computes the scan); each row prints its
               schedule and kernels per call, and the build line the SSD
               library's ``HMMA`` / ``HGMMA`` counts;
 14. serve_generate_ssm — mamba2-780m at published width (48 layers, d
               1536, bf16, seeded weights) through the launcher: 32
               requests x 16 new tokens over 8 slots, bio controller; the
               SSD kernel's launch counter zeroed just before and read just
               after, and it must have launched; the attention kernels not;
 15. parity_generate_ssm — published width at depth 2 in f32, a 300-token
               prompt (more than one 256-token chunk): prefill logits on the
               card (kernel path) against the CPU (the model's chunked
               path) within 1e-3 and 8 greedy tokens equal; full depth (48
               layers) in f32 on the card, kernel path against
               ``attn_impl="xla"`` on 8 prompts of 300 tokens: prefill
               logits within 1e-3 of the largest, first tokens equal, every
               first divergence of 16 greedy tokens a near-tie (printed with
               its top-2 gap and logit error); the served model at full
               depth in bf16, kernel path against ``attn_impl="xla"``;
 16. breakdown_generate_ssm — one mamba2 decode step at 8 slots, device
               time and time from Python, beside its bytes bound;
 17. the MoE and MLA families (``families``; each model freed before
               the next is built): ``moe_layer`` — one granite MoE layer
               at published width in f32 (40 experts of 512, top-8) on
               the card and the CPU from the same weights and inputs, at
               capacity factor 0.5 (tokens drop) and 1.25: routing equal,
               outputs within 1e-4, the dropped count; then
               granite-moe-3b-a800m (32 layers, d 1536, bf16, seeded)
               through the launcher, 32 requests of 16 + 16 tokens over 8
               slots, on the contiguous pool (``serve_generate_moe``:
               flash and flash-decode launched, nothing else) and on a
               paged pool of 16-row blocks (``serve_generate_moe_paged``:
               flash and paged flash-decode), each with the counters
               zeroed just before and read just after, ms per step and
               per prefill call, tokens per busy second and the weight
               bytes beside their read at the HBM peak; ``step_moe``: one
               decode step's device ms, ms from Python and kernels (the
               profiler); ``parity_generate_moe``: depth 2 in f32, TF32
               off, the kernel path against the kernels' plain versions
               (``attn_impl="ref"``) on the same weights, equal tokens for
               16 requests, the logits' largest difference, and at full
               depth in bf16 the lockstep greedy agreement;
               ``decode_graph`` for granite; then minicpm3-4b (62 layers,
               d 2560, MLA, bf16, seeded) through the launcher greedy
               (``serve_generate_mla``) and sampled
               (``serve_generate_mla_sampled``), the latent decode kernel
               launched and no other attention kernel; ``step_mla``;
               ``parity_generate_mla``: depth 2 in f32, the card (the
               latent kernel's f32 instance) against the CPU, equal
               tokens for 16 requests and prefill logits within 1e-3;
               ``decode_graph`` for minicpm3, latent launches equal to
               layers x steps (``--latent`` runs these minicpm3 phases
               after ``latent_decode``);
 17b. latent_decode — the MLA latent decode kernel against its plain
               version at the Moonlight cell's shape (256 slots of 2048
               rows, 16 heads, r 512, rope 64) in bf16 and f32 and at
               MiniCPM3's widths, live lengths drawn as the backlog's:
               the row-scaled error within 1e-4, device ms beside the
               bound (the live rows once at the HBM peak), the plain
               version's ms and the launches of one call (run after
               ``attention``); then ``decode_graph`` for Moonlight whole,
               latent launches equal to 27 x steps;
 18. training (``--train`` runs these alone; no kernel is on this
               path: a train step differentiates the einsum and chunked
               paths, and each phase gates every kernel counter at 0):
               ``train_parity`` — stablelm-3b at published width, depth 2,
               f32: one ``make_train_step`` step on the card and on the CPU
               from the same weights and batch (2 x 64 tokens), loss and
               grad norm within 1e-5 / 1e-4 relative, the first moments
               within 1e-4 of each leaf's largest, the parameters within
               1e-6 where the gradient is at least 100 x Adam's eps (within
               a step's length elsewhere); ``train_lm`` — the launcher,
               ``--arch stablelm-3b --full-config --steps 20 --batch 8
               --seq 512`` (remat ``full``, bf16): every loss finite, the
               last below the first, the peak memory under the card's;
               step ms, tokens/s, MFU, peak GB beside the weights',
               gradients' and moments' 12 bytes a parameter;
               ``train_breakdown`` — the same step cut into forward,
               backward (with the recompute) and the in-place AdamW, and
               the profiler's products; ``train_families`` — mamba2
               (chunk 256), granite, minicpm3, recurrentgemma (depth 3),
               paligemma and whisper at published width, depth 2, bf16, 3
               steps on one batch of 2 x 256: the loss falls, every
               gradient and parameter finite, granite's aux positive,
               whisper's encoder and paligemma's prefix embeddings given
               nonzero gradients; ``checkpoint`` — the parity model (f32)
               and whisper's (bf16) with their AdamW states saved in the
               reference's layout and loaded into fresh models on the
               card, byte for byte; ``quant`` — stablelm-3b at published
               width through ``quantize_tree`` on the stacked layout,
               dequantised to bf16: one decode step at 8 rows against the
               bf16 model's, the largest logit error under 0.15 of the
               largest and top-1 agreement of 0.5 or more, the int8
               tree's bytes against bf16's;
 19. sharding (``--shard`` runs these alone, with the whole dry-run
               matrix): ``shard_specs`` — the parameter specs of
               stablelm-3b, granite and llama3-405b at published width
               on 16 x 16, with and without fsdp (meta models): the
               leaves over "model" and over "data"; ``serve_sharded`` —
               stablelm-3b at published width, bf16, on a one-rank NCCL
               group and a 1 x 1 mesh on the card: 8 slots over 128
               rows, a 16-token prefill and 16 greedy decode steps under
               ``sharding.sharded`` on DTensor parameters, cache and
               tokens, against the same steps without the mesh (tokens
               byte-equal, logits within ``ATTN_BF16_ROW_TOL`` row-
               scaled), flash and decode attention launched through
               ``kernels.ops``' ``local_map``, the uncaptured ms per
               decode step both ways; ``dryrun`` — ``launch.dryrun`` in a
               subprocess (the fake group of 256 ranks, no card): the
               stablelm ``decode_32k`` line and its record; with
               ``--shard``, every arch on both meshes too (one process
               an arch, all at once) and the ok / skip / fail counts;
 20. kernels — one line with every kernel's numbers (the chunk entry
               too; each kernel's launches summed over its main paths,
               with ``launches_by_path``: entropy's the four classify
               runs and the fleet's live runs (``fleet``), each attention
               kernel's stablelm's and granite's, the split-phase runs'
               as ``serve_disagg`` and ``serve_disagg_paged``, the live
               generate replicas' as ``fleet_generate``, the sharded
               run's as ``serve_sharded``; the disagg
               shapes' rows under ``new_shapes``;
               granite's G = 3 case as ``g3``);
 21. the last line: ``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero without CUDA or without the repo.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.core import (AdaptiveThreshold,  # noqa: E402
                              AdmissionController, DecayingThreshold,
                              EnergyMeter, LatencyModel)
from repro_torch.core.energy import energy_model_for  # noqa: E402
from repro_torch.disagg import (DisaggEngine,  # noqa: E402
                                DisaggSimulator, PhaseAwareRouter,
                                build_disagg_fleet)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as da_mod  # noqa: E402
from repro_torch.kernels import entropy as ent_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import latent_decode as ld_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.runtime import (ATTN_BF16_ROW_TOL,  # noqa: E402
                                         row_scaled_error)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import convert, distilbert, quant  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import continuous as cont  # noqa: E402
from repro_torch.serving import sampling as smp  # noqa: E402
from repro_torch.serving import (PATH_DIRECT,  # noqa: E402
                                 AdmissionMiddleware, CallableEngineAdapter,
                                 ClassifierEngine, ClosedLoopSimulator,
                                 DirectPath, DynamicBatcher, InferRequest,
                                 Oracle, OracleEngine, Server, ServerConfig,
                                 closed_loop_arrivals)
from repro_torch.serving.engine import GenerationEngine  # noqa: E402
from repro_torch.serving.gated import make_gated_classify_step  # noqa: E402
from repro_torch.telemetry.validate import main as validate_main  # noqa: E402
from repro_torch.training import (AdamW, ClassificationData,  # noqa: E402
                                  checkpoint, lm_batches, lm_loss,
                                  make_train_step, train_classifier)

F32_TOL = 1e-4          # tests/test_kernels.py:30
BF16_TOL = 3e-2
LOGITS_TOL = 1e-3       # CUDA vs CPU full model: other sum orders over d_ff
# mamba2 at full depth in f32, the SSD kernel against the model's chunked
# path on the card, relative to the largest |logit|: both are f32 and
# differ only in sum order (other chunk lengths, other product units), a
# difference of order 1e-6 of each layer's output; the 48 residual
# layers add such differences, about 1e-4 at most, so 1e-3 leaves a
# margin of ten, while a dropped chunk state or a wrong decay moves a
# layer's output by its own size
FULL_F32_LOGITS_TOL = 1e-3
# published dense peaks (NVIDIA data sheets): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, bf16 and TF32 FLOP/s on the tensor cores
PEAKS = {"sxm": {"hbm": 3.35e12, "f32": 67e12, "bf16": 989e12,
                 "tf32": 495e12},
         "pcie": {"hbm": 2.0e12, "f32": 51e12, "bf16": 756e12,
                  "tf32": 378e12}}
ARCH = "stablelm-3b"
SSM_ARCH = "mamba2-780m"
ENTROPY_OPS_PER_ELEMENT = 6   # compare, subtract, exp, 2 mul-adds, add


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail_unless(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def _elapsed_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events: the card's time, plus any gap in which it
    waited for the host to issue the next launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _elapsed_ms(lambda: [fn() for _ in range(iters)]) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured into one
    CUDA graph and replayed, so the host's cost of issuing each call
    (Python, the wrapper's checks, the launch itself) is left out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    ms = _elapsed_ms(lambda: [g.replay() for _ in range(replays)])
    del g
    return ms / (replays * iters)


def entropy_bound_ms(B: int, V: int, itemsize: int, peaks: dict):
    """Least time for the work: inputs read once, outputs written once
    (f32 H, f32 p_max, i32 argmax), or its f32 operations at peak."""
    t_bytes = (B * V * itemsize + 12 * B) / peaks["hbm"]
    t_ops = ENTROPY_OPS_PER_ELEMENT * B * V / peaks["f32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    idle = nvidia_smi("power.draw")
    print(smi, flush=True)
    em = energy_model_for(name)
    emit(phase="device", name=name,
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         idle_power_draw=idle, assumed_idle_w=em.p_idle,
         torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi, idle


def _cuobjdump():
    """The CUDA toolkit's ``cuobjdump``, or the one Triton carries; None
    where neither exists."""
    for d in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if d and os.path.isfile(os.path.join(d, "bin", "cuobjdump")):
            return os.path.join(d, "bin", "cuobjdump")
    try:
        import triton
    except ImportError:
        return None
    tool = os.path.join(os.path.dirname(triton.__file__), "backends",
                        "nvidia", "bin", "cuobjdump")
    return tool if os.path.isfile(tool) else None


def sass_count(lib: str, opcode: str):
    """How many ``opcode`` instructions the library's SASS holds, or
    "not available" without a ``cuobjdump``."""
    tool = _cuobjdump()
    if tool is None:
        return "not available"
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return sum(ln.split()[1].startswith(opcode) for ln in sass.splitlines()
               if ln.strip().startswith("/*") and len(ln.split()) > 1)


def _ptxas_report(lines) -> dict:
    """``nvcc -Xptxas -v``'s report, one entry per kernel instantiation
    (the mangled name from the kernel's own name on, template arguments
    included): its registers, then its stack and spills."""
    out, fn = {}, None
    for ln in lines:
        ln = ln.strip()
        if "Function properties for" in ln:
            fn = ln.rsplit(" ", 1)[-1]
            m = re.search(r"\d+([A-Za-z_]*kernel\w*)", fn)
            fn = m.group(1)[:72] if m else fn
            out[fn] = []
        elif fn is not None and ("spill" in ln or "registers" in ln):
            out[fn].append(ln.replace("ptxas info    : ", ""))
    return {k: "; ".join(v) for k, v in out.items()}


def phase_build():
    t0 = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, p in paths.items():
        log = str(p) + ".log"
        if os.path.exists(log):
            with open(log) as f:
                ptxas[name] = _ptxas_report(f)
    flash = str(paths["flash_attention"])
    hgmma = sass_count(flash, "HGMMA")
    fail_unless(hgmma == "not available" or hgmma > 0,
                "flash_attention: the tensor-core body holds HGMMA")
    ssd = str(paths["ssd_scan"])
    ssd_tc = {op: sass_count(ssd, op) for op in ("HMMA", "HGMMA")}
    fail_unless("not available" in ssd_tc.values() or sum(ssd_tc.values()),
                "ssd_scan: the chunk-parallel products hold HMMA or HGMMA")
    latent_hmma = sass_count(str(paths["latent_decode"]), "HMMA")
    fail_unless(latent_hmma == "not available" or latent_hmma > 0,
                "latent_decode: the bf16 instances' products hold HMMA")
    # the hd-256 instances: the tensor-core flash body and the wide decode
    # body (registers and spills as ptxas reports them)
    hd256 = {f"{lib}:{fn}": rep for lib in ("flash_attention",
                                             "decode_attention")
             for fn, rep in ptxas.get(lib, {}).items()
             if "ILi256" in fn or fn.startswith("decode_wide_kernel")}
    # the GQA decode body's instances, by types, layout, heads and head dims
    gqa = {fn: rep for fn, rep in ptxas.get("decode_attention", {}).items()
           if fn.startswith("decode_kernel_gqa")}
    emit(phase="build", seconds=secs,
         library_seconds=dict(build.build_seconds),
         libraries={n: os.path.relpath(p, ROOT) for n, p in paths.items()},
         flash_sass_hgmma=hgmma, ssd_sass_hmma=ssd_tc["HMMA"],
         ssd_sass_hgmma=ssd_tc["HGMMA"], latent_sass_hmma=latent_hmma,
         ptxas_hd256=hd256, ptxas_gqa=gqa, ptxas=ptxas)


# entropy cases: the gated step's [64 or 128, 2] and its edges (one row,
# 300 rows that fill no block, V = 1), a warp-per-row width, the proxy
# and vocabulary widths (odd V: rows off 16-byte alignment) in f32 and bf16
ENTROPY_CASES = [((1, 2), torch.float32), ((64, 2), torch.float32),
                 ((128, 2), torch.float32), ((300, 2), torch.float32),
                 ((64, 1), torch.float32), ((8, 2048), torch.bfloat16),
                 ((64, 50304), torch.float32), ((8, 256000), torch.float32),
                 ((16, 50257), torch.float32), ((8, 50257), torch.bfloat16)]
# the split count of 8 x 256000 f32 on a 132-SM card; phase_kernel takes
# the card's own, and entropy_inputs plants ties on its slice boundaries
TIE_SPLITS = 63


def _tied_rows(dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(6, 1000, generator=g, device=dev)
    x[0, [3, 700]] = 9.0          # tie across lanes
    x[1, [5, 5 + 256]] = 9.0      # tie inside one lane's stride
    x[2, [998, 999]] = 9.0        # tie inside the last vector
    x[3] = 0.5                    # uniform row: index 0 wins
    x[4, [0, 999]] = 9.0
    x[5, [31, 32]] = 9.0          # tie across two lanes' vectors
    return x


def _split_tied_rows(dev, splits) -> torch.Tensor:
    """8 x 256000 f32 with ties straddling the boundaries of ``splits``
    slices: rows 0-5 the boundaries before slices 1, 2, n/3, n/2, n-2 and
    n-1, row 6 across two vectors inside a slice, row 7 the row's first
    and last column.  Slice k starts at column 4 floor(64000 k / n)
    (16-byte vectors of an aligned row)."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(8, 256000, generator=g, device=dev) * 4
    n = splits
    for r, k in enumerate((1, 2, n // 3, n // 2, n - 2, n - 1)):
        b = 4 * (64000 * k // n)
        x[r, [b - 1, b]] = 50.0
    x[6, [4 * 777 + 3, 4 * 778]] = 50.0
    x[7, [0, 255999]] = 50.0
    return x


def entropy_inputs(dev, tie_splits=TIE_SPLITS) -> list:
    """(label, logits) of every entropy case, from fixed seeds."""
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = [(f"{B}x{V}" + ("_bf16" if dt == torch.bfloat16 else ""),
               (torch.randn(B, V, generator=g, device=dev) * 4).to(dt))
              for (B, V), dt in ENTROPY_CASES]
    inputs.append(("tied_6x1000", _tied_rows(dev)))
    inputs.append(("tied_2x2", torch.tensor([[1.5, 1.5], [-2.0, -2.0]],
                                            device=dev)))
    inputs.append(("tied_split_8x256000", _split_tied_rows(dev, tie_splits)))
    return inputs


def check_entropy(label: str, x: torch.Tensor, out) -> float:
    """Hold the kernel's (entropy, max_prob, argmax) against the plain
    version: within F32_TOL for bf16 input too (both upcast it exactly
    and compute in f32), argmax equal, and the first index on a tie;
    -> the largest absolute error."""
    h, p, a = out
    hr, pr, ar = ent_mod.entropy_stats_plain(x)
    torch.cuda.synchronize()
    err = max((h - hr).abs().max().item(), (p - pr).abs().max().item())
    fail_unless(torch.allclose(h, hr, rtol=F32_TOL, atol=F32_TOL)
                and torch.allclose(p, pr, rtol=F32_TOL, atol=F32_TOL),
                f"entropy {label}: max abs err {err}")
    fail_unless(torch.equal(a, ar), f"entropy argmax {label}")
    fail_unless(bool(torch.isfinite(h).all() and torch.isfinite(p).all()),
                f"entropy {label}: non-finite output")
    if label.startswith("tied"):
        first = (x == x.amax(-1, keepdim=True)).int().argmax(-1)
        fail_unless(torch.equal(a, first.to(torch.int32)),
                    f"{label}: first index must win a tie")
    return err


def cold_ms(fn, x: torch.Tensor) -> float:
    """Device time per call of ``fn`` over a ring of copies of ``x`` that
    together hold twice the card's L2, each call reading the copy read
    least recently: its input comes from HBM, as the bytes bound
    assumes, not from the L2 that replays of one input hit."""
    l2 = getattr(torch.cuda.get_device_properties(x.device),
                 "L2_cache_size", 0) or 50 * 2**20
    n = max(2, -(-2 * l2 // (x.numel() * x.element_size())))
    ring = [x.clone() for _ in range(n)]
    turn = itertools.cycle(ring)
    ms = graph_ms(lambda: fn(next(turn)), 2 * n)
    del ring
    return ms


def phase_kernel(peaks: dict):
    """The entropy kernel at every case, under the schedule the wrapper
    picks, beside the launch floor, its bound, the plain version and the
    library call; a split row is also timed on inputs that miss the L2
    (``cold_ms``)."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    floor = {"ms": graph_ms(lambda: ent_mod.empty_kernel_cuda(dev), 200),
             "call_ms": time_ms(lambda: ent_mod.empty_kernel_cuda(dev), 200)}
    emit(phase="launch_floor", kernel="entropy_empty: one warp, no work",
         **floor)
    tie_splits = ent_mod.entropy_schedule(8, 256000, 4, sms)["splits"]
    max_err, main, schedules = 0.0, None, {}
    for label, x in entropy_inputs(dev, tie_splits):
        B, V = x.shape
        plan = ent_mod.entropy_schedule(
            B, V, x.element_size(), sms,
            offset=x.data_ptr() % ent_mod.VEC_BYTES)
        before = ent_mod.launches
        out = ent_mod.entropy_stats_cuda(x)
        fail_unless(ent_mod.launches == before + 1,
                    f"entropy {label}: one launch counted per call")
        err = check_entropy(label, x, out)
        max_err = max(max_err, err)
        iters = 200 if B * V < 1e6 else 20
        row = dict(phase="kernel", name="entropy_stats", case=label,
                   shape=[B, V], dtype=str(x.dtype).replace("torch.", ""),
                   schedule=plan["schedule"], splits=plan["splits"],
                   threads=plan["threads"], blocks=plan["blocks"],
                   max_abs_err=err, argmax_equal=True,
                   library_computes="entropy only (torch.distributions."
                                    "Categorical(logits).entropy())")
        fns = {"": lambda: ops.entropy_stats(x, impl="cuda"),
               "plain_": lambda: ent_mod.entropy_stats_plain(x),
               "library_": lambda: torch.distributions.Categorical(
                   logits=x, validate_args=False).entropy()}
        for prefix, fn in fns.items():
            row[prefix + "ms"] = graph_ms(fn, iters)
            row[prefix + "call_ms"] = time_ms(fn, iters)
        if plan["schedule"] == "split":
            row["cold_ms"] = cold_ms(ent_mod.entropy_stats_cuda, x)
        row["bound_ms"], row["bound_by"] = entropy_bound_ms(
            B, V, x.element_size(), peaks)
        row["floor_ms"] = floor["ms"]
        emit(**row)
        schedules[label] = plan["schedule"] + (
            f" {plan['splits']}" if plan["splits"] > 1 else "")
        if label == "64x2":          # the gated path's [batch, n_classes]
            main = row
        if label == "8x256000":
            _two_streams(x)
            _two_graphs(x)
    return max_err, main, schedules, floor["ms"]


def _two_streams(x: torch.Tensor, calls: int = 8) -> None:
    """The split schedule's ticket merge from two streams at once: each
    stream keeps its own tickets, so every result equals one stream's."""
    want = ent_mod.entropy_stats_cuda(x)
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(calls):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(ent_mod.entropy_stats_cuda(x))
    torch.cuda.synchronize()
    fail_unless(all(torch.equal(o[2], want[2]) and torch.allclose(
        o[0], want[0], rtol=F32_TOL, atol=F32_TOL) for o in outs),
        "entropy from two streams at once equals one stream's")
    emit(phase="kernel_two_streams", shape=list(x.shape), calls=len(outs),
         equal=True)


def _two_graphs(x: torch.Tensor, calls: int = 4, rounds: int = 8) -> None:
    """Two CUDA graphs of the split schedule, both captured on torch's one
    default capture stream, replayed at once on two streams: each graph
    owns its tickets, so every replay's results equal a direct call's."""
    want = ent_mod.entropy_stats_cuda(x)
    graphs, outs = [], []
    for xi in (x.clone(), x.clone()):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            outs.append([ent_mod.entropy_stats_cuda(xi)
                         for _ in range(calls)])
        graphs.append(g)
    streams = [torch.cuda.Stream() for _ in graphs]
    torch.cuda.synchronize()
    got = []
    for _ in range(rounds):
        for g, st, o in zip(graphs, streams, outs):
            with torch.cuda.stream(st):
                g.replay()
                got += [tuple(t.clone() for t in r) for r in o]
    torch.cuda.synchronize()
    fail_unless(all(torch.equal(o[2], want[2]) and torch.allclose(
        o[0], want[0], rtol=F32_TOL, atol=F32_TOL) for o in got),
        "entropy from two graphs replayed at once equals a direct call's")
    emit(phase="kernel_two_graphs", shape=list(x.shape), graphs=2,
         calls=calls, rounds=rounds, results=len(got), equal=True)
    del graphs


def phase_train_classifier():
    """The launcher's ``build_classifier()`` on the card, timed; then the
    same init (drawn on the card from seed 0, copied across) trained on
    the CPU over the same batches, and the two held against each other
    on the launcher's 2,000 requests through the served heads (full,
    and the proxy after ``--exit-layer 1``)."""
    t0 = time.perf_counter()
    cfg, model, data, log = serve.build_classifier()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    fail_unless(log[-1]["ce"] < log[0]["ce"],
                f"train_classifier: ce {log[0]['ce']} -> {log[-1]['ce']}")
    init = distilbert.init(cfg, seed=0, device="cuda")
    cpu_model = distilbert.DistilBERT(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               init.state_dict().items()})
    t0 = time.perf_counter()
    cpu_model, cpu_log = train_classifier(
        cpu_model, data.train_batches(32), steps=150,
        verbose=False, device="cpu")
    cpu_s = time.perf_counter() - t0
    toks, labels, _ = data.sample(2000)
    heads = {}
    with torch.inference_mode():
        for name, m, x in (("card", model, torch.from_numpy(toks).long()
                            .cuda()),
                           ("cpu", cpu_model, torch.from_numpy(toks).long())):
            heads[name] = (m.logits(x).cpu(),
                           m.early_exit_logits(x, exit_layer=1).cpu())
    (cf, ce), (pf, pe) = heads["card"], heads["cpu"]
    agree = float((cf.argmax(-1) == pf.argmax(-1)).float().mean())
    agree_exit = float((ce.argmax(-1) == pe.argmax(-1)).float().mean())
    lab = torch.from_numpy(labels).long()
    fail_unless(bool(torch.isfinite(cf).all() and torch.isfinite(ce).all()),
                "train_classifier: finite logits")
    fail_unless(min(agree, agree_exit) >= 0.99,
                f"train_classifier: card and CPU predictions agree on "
                f"{agree} (full) and {agree_exit} (exit) of 2,000")
    emit(phase="train_classifier", steps=150, card_s=card_s, cpu_s=cpu_s,
         ce_first=log[0]["ce"], ce_last=log[-1]["ce"],
         cpu_ce_last=cpu_log[-1]["ce"],
         full_logits_max_abs_diff=(cf - pf).abs().max().item(),
         exit_logits_max_abs_diff=(ce - pe).abs().max().item(),
         predictions_agree=agree, exit_predictions_agree=agree_exit,
         accuracy_full=float((cf.argmax(-1) == lab).float().mean()),
         accuracy_exit1=float((ce.argmax(-1) == lab).float().mean()))
    return cfg, model, data


def _serve(path: str, extra: list[str]):
    args = serve.parser().parse_args(
        ["--device", "cuda", "--path", path, "--controller", "bio",
         "--runs", os.path.join(ROOT, "build", "chip_smoke_runs"), *extra])
    ent_mod.launches = 0
    t0 = time.perf_counter()
    summary, server = serve.serve_classifier(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ent_mod.launches
    resp = server.responses
    fail_unless(len(resp) == args.requests
                and sorted(r.rid for r in resp) == list(range(args.requests)),
                f"{path}: every request answered once")
    fail_unless(all(r.output in (0, 1) for r in resp),
                f"{path}: every output a class id")
    ents = [r.telemetry["entropy"] for r in resp if "entropy" in r.telemetry]
    ents += [r.decision.L for r in resp if r.decision is not None]
    fail_unless(len(ents) > 0 and all(math.isfinite(e) for e in ents),
                f"{path}: finite entropies")
    fail_unless(all(math.isfinite(v) for v in summary.values()
                    if isinstance(v, float)), f"{path}: no NaN in summary")
    fail_unless(launches > 0, f"{path}: entropy kernel launched on the path")
    emit(phase="serve", seconds=secs, full_width="--full-width" in extra,
         entropy_launches=launches, **summary)
    return launches


def phase_serve():
    """Each path on the launcher's trained default (trained within the
    run) and on the full-width model."""
    out = {}
    for tag, extra in (("", []), ("_full_width", ["--full-width"])):
        out["gated" + tag] = _serve(
            "gated", ["--max-batch", "64", "--requests", "256", *extra])
        out["auto" + tag] = _serve("auto", ["--requests", "300", *extra])
    return out


def _policy(oracle, labels, em, direct_lat, batched_lat, *, enabled,
            adaptive_target=None, n=2000):
    """One Table III policy through ``Server`` + ``OracleEngine``, as
    ``benchmarks/table3_ablation.py`` runs it (tau_inf 0.6, k 3)."""
    if adaptive_target is not None:
        th = AdaptiveThreshold(base=DecayingThreshold(1.0, 0.6, 3.0),
                               target_rate=adaptive_target, kp=0.6,
                               ki=0.08)
    else:
        th = DecayingThreshold(tau0=1.0, tau_inf=0.6, k=3.0)
    server = Server(
        OracleEngine(oracle, DirectPath(direct_lat),
                     DynamicBatcher(batched_lat, max_batch_size=16,
                                    queue_window_s=0.004)),
        ServerConfig(path="auto", energy_model=em),
        middleware=[AdmissionMiddleware(AdmissionController(
            threshold=th, enabled=enabled,
            meter=EnergyMeter(model=em)))])
    server.serve(closed_loop_arrivals(n, think_s=direct_lat.t_fixed_s * 0.8,
                                      labels=labels))
    return server.summary()


def phase_system(cfg, model, data):
    """``tests/test_system.py``'s claims on the card-trained classifier
    (its fixed latency models, ``ClosedLoopSimulator``, the proxy after
    2 layers), then a Table III-shaped row pair, printed only, with
    latency models calibrated on the card."""
    em = serve.device_energy_model(torch.device("cuda"))
    engine = ClassifierEngine(cfg, model, exit_layer=2, device="cuda")
    n = 800
    toks, labels, _ = data.sample(n)
    proxy_pred, entropy, _, _ = engine.proxy_scores(toks)
    full_pred, _ = engine.classify(toks)
    oracle = Oracle(full_pred=full_pred, proxy_pred=proxy_pred,
                    entropy=entropy, labels=labels,
                    proxy_latency=LatencyModel(0.0003, 0.0))
    reqs = closed_loop_arrivals(n, think_s=0.002)

    def run(enabled):
        ctrl = AdmissionController(
            threshold=DecayingThreshold(tau0=1.0, tau_inf=0.45, k=3.0),
            enabled=enabled, meter=EnergyMeter(model=em))
        return ClosedLoopSimulator(
            oracle=oracle, controller=ctrl,
            direct=DirectPath(LatencyModel(0.002, 0.003)),
            batched=DynamicBatcher(LatencyModel(0.015, 0.001),
                                   max_batch_size=16, queue_window_s=0.004),
            energy_model=em, path="auto").run(reqs)

    m_open, m_bio = run(False), run(True)
    fail_unless(m_open.admission_rate == 1.0 and m_bio.admission_rate < 0.9,
                f"system: admission open {m_open.admission_rate}, "
                f"bio {m_bio.admission_rate}")
    fail_unless(m_bio.busy_s < m_open.busy_s
                and m_bio.energy_j < m_open.energy_j,
                "system: bio saves busy time and energy")
    fail_unless(m_open.accuracy - m_bio.accuracy < 0.10,
                f"system: accuracy {m_open.accuracy} -> {m_bio.accuracy}")
    toks, labels, _ = data.sample(600)
    proxy_pred, _, _, _ = engine.proxy_scores(toks)
    full_pred, _ = engine.classify(toks)
    acc_full = float(np.mean(full_pred == labels))
    acc_proxy = float(np.mean(proxy_pred == labels))
    fail_unless(acc_full >= acc_proxy,
                f"system: full {acc_full} vs proxy {acc_proxy}")
    diff = np.concatenate([np.full(300, 0.2), np.full(300, 0.95)])
    toks, _, _ = data.sample(600, difficulty=diff)
    _, entropy, _, _ = engine.proxy_scores(toks)
    ent_easy, ent_hard = float(entropy[:300].mean()), float(
        entropy[300:].mean())
    fail_unless(ent_hard > ent_easy,
                f"system: entropy hard {ent_hard} vs easy {ent_easy}")
    emit(phase="system", open=m_open.summary(), bio=m_bio.summary(),
         accuracy_full=acc_full, accuracy_proxy=acc_proxy,
         entropy_easy=ent_easy, entropy_hard=ent_hard)
    # Table III's shape at latencies measured on the card
    toks, labels, _ = data.sample(2000)
    proxy_pred, entropy, _, t_proxy = engine.proxy_scores(toks)
    full_pred, _ = engine.classify(toks)
    oracle = Oracle(full_pred=full_pred, proxy_pred=proxy_pred,
                    entropy=entropy, labels=labels,
                    proxy_latency=LatencyModel(t_proxy / 2000, 0.0))
    times = engine.calibrate(seq_len=toks.shape[1], buckets=(1, 4, 16))
    t_tok = max((times[16] - times[1]) / 15, 1e-5)
    base = max(times[1] - t_tok, 1e-4)
    lats = (LatencyModel(base, t_tok), LatencyModel(base * 6, t_tok))
    std = _policy(oracle, labels, em, *lats, enabled=False)
    for name, kw in (("bio-controller", {}),
                     ("bio-adaptive(target=0.58)",
                      {"adaptive_target": 0.58})):
        s = _policy(oracle, labels, em, *lats, enabled=True, **kw)
        emit(phase="table3_row", policy=name, against="standard(open-loop)",
             time_saving_pct=100 * (std["busy_s"] - s["busy_s"])
             / std["busy_s"],
             energy_saving_pct=100 * (std["energy_kwh"] - s["energy_kwh"])
             / std["energy_kwh"],
             admission_rate=s["admission_rate"],
             accuracy_drop_pp=100 * (std["accuracy"] - s["accuracy"]),
             calibrated_ms={b: t * 1e3 for b, t in times.items()})


FLEET_REQUESTS = 600
FLEET_OUTLIER = 10.0   # a replica's largest batch walltime over its median


def _fleet_run(tag: str, flags: list[str], idle_w: float,
               classifier=None) -> dict:
    """One ``serve_fleet`` run through the launcher's own flags, its
    trace and metrics written and validated, the card's energy counter
    read around it (``--energy-source nvml``), the entropy kernel's
    launches counted from just before to just after."""
    out_dir = os.path.join(ROOT, "build", "chip_smoke_fleet")
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, f"{tag}.trace.json")
    metrics = os.path.join(out_dir, f"{tag}.metrics.json")
    args = serve.parser().parse_args(
        ["--device", "cuda", "--requests", str(FLEET_REQUESTS),
         "--max-batch", "8", "--runs", os.path.join(ROOT, "build",
                                                    "chip_smoke_runs"),
         "--trace-out", trace, "--metrics-out", metrics,
         "--energy-source", "nvml", *flags])
    ent_mod.launches = 0
    t0 = time.perf_counter()
    out, report, pool = serve.serve_fleet(args, classifier=classifier)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = ent_mod.launches
    n = args.requests
    resp = report.responses
    rids = [r.rid for r in resp]
    fail_unless(sorted(rids) == list(range(n)),
                f"fleet {tag}: every request answered exactly once")
    rejected = [r for r in resp if r.path == "reject"]
    fail_unless(all(r.telemetry.get("reason") for r in rejected),
                f"fleet {tag}: every rejection carries its reason")
    fail_unless(args.chaos is not None or not rejected,
                f"fleet {tag}: no rejection without faults")
    fail_unless(out["n_served"] + out["n_rejected"] == n,
                f"fleet {tag}: served + rejected = requests")
    fail_unless(validate_main([trace, metrics, "--require-gauge",
                               "compile_seconds", "energy_drift_ratio",
                               "fleet_pressure"]) == 0,
                f"fleet {tag}: trace and metrics validate")
    drift = out["energy_drift"]
    # the counter steps every few tens of ms: a live run's window of
    # seconds must see it move; the sim run's may be shorter than a step
    fail_unless(drift["source"] == "nvml" and drift["measured_j"] >= 0
                and (drift["measured_j"] > 0 or not args.fleet_live),
                f"fleet {tag}: the card's energy counter read {drift}")
    if args.fleet_live:
        fail_unless(launches > 0,
                    f"fleet {tag}: entropy kernel launched on the path")
    lat = np.array([r.t_finish - r.arrival_s for r in resp])
    walltimes = {}
    for rep in pool:
        bt = np.asarray(getattr(rep.server.engine, "batch_times", []))
        if len(bt):
            walltimes[rep.name] = {
                "calls": int(len(bt)), "median_ms": float(np.median(bt)) * 1e3,
                "max_ms": float(bt.max()) * 1e3,
                "max_over_median": float(bt.max() / np.median(bt))}
    line = dict(
        phase="fleet", run=tag, live=bool(args.fleet_live),
        chaos=args.chaos, scenario=out["scenario"], requests=n,
        n_layers=out.get("n_layers"), d_model=out.get("d_model"),
        routed=out["routed"], admission_rate=out["admission_rate"],
        # the router's marginal-energy signal: each replica's prior (from
        # the calibrated buckets) and its EnergyMeter EWMA at the end
        prior_j={rep.name: rep.energy_prior_j for rep in pool},
        ewma_j={r["name"]: r["ewma_j_per_req"] for r in out["per_replica"]},
        n_served=out["n_served"], n_rejected=out["n_rejected"],
        n_retries=out["n_retries"], n_failures=out["n_failures"],
        p50_latency_ms=float(np.percentile(lat, 50)) * 1e3,
        p95_latency_ms=float(np.percentile(lat, 95)) * 1e3,
        span_s=out["span_s"], modelled_j=out["energy_j"],
        busy_s=float(sum(rep.busy_s for rep in pool)), wall_s=wall_s,
        nvml_window_s=drift["window_s"], nvml_j=drift["measured_j"],
        idle_power_w=idle_w, idle_j_in_window=idle_w * drift["window_s"],
        drift_ratio=drift["drift_ratio"],
        compile_seconds=drift["compile"]["compile_seconds"],
        entropy_launches=launches, batch_walltimes=walltimes,
        outliers=sorted(k for k, v in walltimes.items()
                        if v["max_over_median"] > FLEET_OUTLIER),
        autoscaler_actions=out["autoscaler_actions"],
        fault_plan=out.get("fault_plan"))
    emit(**line)
    return line


def phase_fleet(trained, smi: str, device_idle: str) -> dict:
    """The fleet layer on the card through the launcher's ``serve_fleet``:
    three live replicas (direct, dynamic-batch, gated-in-graph; the
    energy-aware router, the autoscaler) on ``flash-crowd`` through the
    trained default and through the full-width DistilBERT, the
    ``crash-storm`` story on the trained default (faults, retry,
    brownout), and the sim fleet's ``flash-crowd`` as a host-only
    baseline; each run's drift audit reads the card's energy counter,
    printed beside the card's draw at rest before the runs (and at the
    start of the smoke, ``device_idle``).
    -> the entropy kernel's launches in each live run."""
    idle = nvidia_smi("power.draw")
    idle_w = float(idle.split()[0])
    runs = {
        "live": _fleet_run("live", ["--fleet-live"], idle_w,
                           classifier=trained),
        "live_full_width": _fleet_run(
            "live_full_width", ["--fleet-live", "--full-width",
                                "--seq-len", "128"], idle_w),
        "chaos": _fleet_run("chaos", ["--fleet-live", "--chaos",
                                      "crash-storm"], idle_w,
                            classifier=trained),
        "sim": _fleet_run("sim", ["--fleet"], idle_w),
    }
    emit(phase="fleet_summary", nvidia_smi=smi, idle_power_draw=idle,
         device_phase_idle_power_draw=device_idle,
         **{k: {f: v[f] for f in ("wall_s", "modelled_j", "nvml_j",
                                  "drift_ratio", "entropy_launches")}
            for k, v in runs.items()})
    torch.cuda.empty_cache()
    return {k: v["entropy_launches"] for k, v in runs.items()
            if v["live"]}


RESNET_TOL = 1e-4     # of the largest |logit|, card vs CPU, f32, TF32 off


def phase_resnet(smi: str):
    """ResNet-18 (100 classes, 64 x 64, seed 1: the reference's
    ``resnet_setup``) through ``CallableEngineAdapter`` and ``Server`` on
    the direct path, 100 requests 0.25 s apart; every answer held against
    the same weights on the CPU."""
    model = resnet.init(100, seed=1, device="cuda")
    cpu_model = resnet.ResNet18(100, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    n = 100
    imgs = torch.randn(n, 1, 64, 64, 3,
                       generator=torch.Generator().manual_seed(0))
    cards = imgs.cuda()
    server = Server(CallableEngineAdapter(model, name="resnet18"),
                    ServerConfig(path=PATH_DIRECT))
    resp = server.serve([InferRequest(rid=i, arrival_s=0.25 * i,
                                      payload=cards[i]) for i in range(n)])
    fail_unless(sorted(r.rid for r in resp) == list(range(n))
                and all(r.path == PATH_DIRECT for r in resp),
                "resnet: every request answered once on the direct path")
    got = torch.cat([r.output for r in sorted(resp, key=lambda r: r.rid)])
    with torch.inference_mode():
        want = cpu_model(imgs.reshape(n, 64, 64, 3))
    err = (got.cpu() - want).abs().max().item()
    scale = want.abs().max().item()
    fail_unless(got.shape == (n, 100) and bool(torch.isfinite(got).all())
                and err <= RESNET_TOL * scale,
                f"resnet: card vs CPU logits {err} of {scale}")
    lat = np.array([r.latency_s for r in resp])
    with torch.inference_mode():
        device_ms = time_ms(lambda: model(cards[0]), 20)
    emit(phase="resnet", requests=n, image=[64, 64, 3], classes=100,
         logits_max_abs_err=err, max_abs_logit=scale,
         ms_per_request=server.busy_s / n * 1e3,
         p50_latency_ms=float(np.percentile(lat, 50)) * 1e3,
         device_ms_batch1=device_ms, nvidia_smi=smi)


def _gated_batch():
    """The full-width model and one gated batch (64 requests of 128
    tokens), as the launcher builds them."""
    cfg = distilbert.config()
    model = distilbert.init(cfg, seed=0, device="cuda")
    toks, _, _ = ClassificationData(vocab=cfg["vocab"], seq_len=128,
                                    seed=1).sample(64)
    return cfg, model, torch.from_numpy(toks).long().cuda()


def encoder_flops(cfg: dict, rows: int, seq: int, layers: int) -> int:
    """Multiply-adds x 2 of ``layers`` encoder layers over rows x seq
    tokens: the q/k/v/o and MLP products plus the scores and the
    weighted sum of attention."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return rows * seq * layers * (2 * (4 * d * d + 2 * d * f) + 4 * seq * d)


def phase_breakdown(cfg, model, x, peaks: dict):
    """Where the gated step's device time goes at batch 64: the proxy
    (one layer over the batch), the entropy kernel, the full model over
    the 32-row bucket, and the whole step, beside the f32 bound of the
    encoder's products (TF32 is off, so they run on the f32 units)."""
    B, S = x.shape
    cap = B // 2
    step = make_gated_classify_step(cfg, exit_layer=1, device="cuda")
    flops = (encoder_flops(cfg, B, S, 1)
             + encoder_flops(cfg, cap, S, cfg["n_layers"]))
    with torch.inference_mode():
        lg = model.early_exit_logits(x, exit_layer=1)
        emit(phase="breakdown", batch=B, bucket=cap, seq=S,
             proxy_ms=time_ms(lambda: model.early_exit_logits(
                 x, exit_layer=1), 10),
             entropy_ms=graph_ms(lambda: ops.entropy_stats(lg), 50),
             full_bucket_ms=time_ms(lambda: model.logits(x[:cap]), 10),
             step_ms=time_ms(lambda: step(model, x, 0.5, 0.5, 0.0, B), 10),
             encoder_gflop=flops / 1e9,
             encoder_f32_bound_ms=flops / peaks["f32"] * 1e3)


def phase_parity(cfg, model, x):
    # the proxy entropy from the kernel vs the plain version, same logits
    with torch.inference_mode():
        lg = model.early_exit_logits(x, exit_layer=1)
        h, p, a = ops.entropy_stats(lg, impl="cuda")
        hr, pr, ar = ops.entropy_stats(lg, impl="ref")
        proxy_err = max((h - hr).abs().max().item(),
                        (p - pr).abs().max().item())
        fail_unless(proxy_err <= F32_TOL and torch.equal(a, ar),
                    f"proxy entropy kernel vs ref: {proxy_err}")
        # the full model on the card vs the same weights on the CPU
        full = model.logits(x[:4]).cpu()
        cpu_model = distilbert.DistilBERT(cfg, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        full_cpu = cpu_model.logits(x[:4].cpu())
    logits_err = (full - full_cpu).abs().max().item()
    fail_unless(bool(torch.isfinite(full).all()) and logits_err <= LOGITS_TOL,
                f"full logits CUDA vs CPU: {logits_err}")
    emit(phase="parity", proxy_entropy_max_abs_err=proxy_err,
         full_logits_cuda_vs_cpu_max_abs_err=logits_err)


# ---------------------------------------------------------------------------
# the generate path: attention kernels, serve, parity, breakdown
# ---------------------------------------------------------------------------

def _bshd_views(shape_bhsd, dtype, gen):
    """Random [B, X, S, hd] data stored BSHD and returned as the BHSD
    view the model passes (the kernels read strides)."""
    B, X, S, hd = shape_bhsd
    x = torch.randn(B, S, X, hd, generator=gen, device="cuda").to(dtype)
    return x.transpose(1, 2)


def _decode_positions(B, S, lengths, ring):
    """kv_pos [B,S] and cur [B] on the card: a valid prefix of
    ``lengths[b]`` rows then -1 (the serving pool), or a ring written
    past its extent up to position ``lengths[b]``."""
    col = torch.arange(S, device="cuda")[None]
    n = torch.as_tensor(lengths, device="cuda")[:, None]
    if ring:
        cur = n[:, 0]
        kv = n - ((n - col) % S)
    else:
        cur = n[:, 0] - 1
        kv = torch.where(col < n, col, -1)
    return kv.to(torch.int32), cur.to(torch.int32)


def attention_bound_ms(kind, case, valid_pairs, peaks):
    """Least time for the work: each input read once and the output
    written once over HBM bandwidth, or the operations the visible
    (query, key) pairs need (4 * hd per pair and head) at the peak of
    the inputs' type; whichever is larger."""
    hd, H, K = case["hd"], case["H"], case["K"]
    isq, iskv = case["qdt"].itemsize, case["kvdt"].itemsize
    B = case["B"]
    if kind == "flash":
        Sq = Skv = case["S"]
        nbytes = 2 * B * H * Sq * hd * isq + 2 * B * K * Skv * hd * iskv
        ops_ = 4 * hd * H * valid_pairs
    else:
        rows = valid_pairs                # valid cache rows over all slots
        nbytes = (2 * B * H * hd * isq + 2 * rows * K * hd * iskv
                  + B * case["S"] * 4 + B * 4)
        if kind == "paged":               # the table of the logical extent
            nbytes += B * (case["S"] // case["bs"]) * 4
        ops_ = 4 * hd * H * rows
    rate = peaks["bf16" if case["kvdt"] == torch.bfloat16 else "f32"]
    t_bytes, t_ops = nbytes / peaks["hbm"], ops_ / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# live rows of granite's 128 slots in the decode-backlog cell: lognormal
# about the ~840 a slot that its live K/V (7.06-7.09 GB over 32 layers)
# works out to, within the 2048-row cache
GRANITE_BACKLOG_ROWS = np.clip(np.round(np.exp(np.random.default_rng(31).normal(
    np.log(840), 0.45, 128))), 64, 2047).astype(int).tolist()
ATTN_CASES = [
    # the generate path's shapes: prefill of up to 8 prompts of 16 tokens,
    # a decode step at 8 slots over the 128-row bf16 pool
    dict(name="prefill_main", kind="flash", B=8, H=32, K=32, S=16, hd=80,
         qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0, iters=200),
    dict(name="decode_main_bf16q", kind="decode", B=8, H=32, K=32, S=128,
         hd=80, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=list(range(17, 33, 2)), ring=False, iters=200),
    dict(name="decode_main_f32q", kind="decode", B=8, H=32, K=32, S=128,
         hd=80, qdt=torch.float32, kvdt=torch.bfloat16, window=0,
         lengths=list(range(17, 33, 2)), ring=False, iters=200),
    # granite-moe-3b-a800m's: 24 query heads over 8 KV heads (G = 3), hd 64
    dict(name="prefill_granite", kind="flash", B=8, H=24, K=8, S=16, hd=64,
         qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0, iters=200),
    dict(name="decode_granite", kind="decode", B=8, H=24, K=8, S=128,
         hd=64, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=list(range(17, 33, 2)), ring=False, iters=200),
    dict(name="paged_granite", kind="paged", B=8, H=24, K=8, S=128, hd=64,
         bs=16, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=list(range(17, 33, 2)), iters=200),
    # granite's decode-backlog cell: 128 slots over a 2048-row cache, live
    # rows about its measured mean of ~840 a slot (two spans, the merge)
    dict(name="decode_granite_backlog", kind="decode", B=128, H=24, K=8,
         S=2048, hd=64, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=GRANITE_BACKLOG_ROWS, ring=False, iters=20),
    # llama3-405b's G = 16 at hd 128 (128 over 8 heads), 8 long contexts
    dict(name="decode_llama3", kind="decode", B=8, H=128, K=8, S=2048,
         hd=128, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=[1500 + 61 * b for b in range(8)], ring=False, iters=20),
    # long shapes
    dict(name="prefill_long", kind="flash", B=1, H=32, K=32, S=2048, hd=80,
         qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0, iters=5),
    dict(name="decode_long", kind="decode", B=8, H=32, K=32, S=4096, hd=80,
         qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=[4096] * 8, ring=False, iters=20),
    # GQA with a window, in f32
    dict(name="prefill_gqa_window", kind="flash", B=2, H=32, K=8, S=512,
         hd=128, qdt=torch.float32, kvdt=torch.float32, window=128,
         iters=20),
    dict(name="decode_gqa_window", kind="decode", B=8, H=32, K=8, S=1024,
         hd=128, qdt=torch.float32, kvdt=torch.float32, window=256,
         lengths=[1500 + 37 * b for b in range(8)], ring=True, iters=50),
    # the paged pool: S is the logical extent, the pool holds every slot's
    # blocks in shuffled order plus the trash block 0; a slot's table
    # entries past its rows point at the trash block
    dict(name="paged_main", kind="paged", B=8, H=32, K=32, S=128, hd=80,
         bs=16, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=list(range(17, 33, 2)), iters=200),
    dict(name="paged_long", kind="paged", B=8, H=32, K=32, S=4096, hd=80,
         bs=16, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=[4096] * 8, iters=20),
    dict(name="paged_gqa_window", kind="paged", B=8, H=32, K=8, S=1024,
         hd=128, bs=32, qdt=torch.float32, kvdt=torch.float32, window=256,
         lengths=[600 + 37 * b for b in range(8)], iters=50),
    # the tensor-core flash body: GQA + window, a ragged prompt, hd 64
    dict(name="prefill_gqa_window_bf16", kind="flash", B=2, H=32, K=8,
         S=512, hd=128, qdt=torch.bfloat16, kvdt=torch.bfloat16,
         window=128, iters=20),
    dict(name="prefill_ragged_bf16", kind="flash", B=2, H=32, K=32, S=1000,
         hd=80, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0, iters=10),
    dict(name="prefill_long_hd64_bf16", kind="flash", B=1, H=16, K=16,
         S=2048, hd=64, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         iters=10),
    # one user's long context: 32 (slot, head) pairs, split into spans
    dict(name="decode_long_b1", kind="decode", B=1, H=32, K=32, S=8192,
         hd=80, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=[8192], ring=False, iters=20),
    dict(name="paged_long_b1", kind="paged", B=1, H=32, K=32, S=8192, hd=80,
         bs=16, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=[8192], iters=20),
    # the smoke configuration's prefill (hd 32): bf16 on the CUDA-core body
    dict(name="prefill_smoke_hd32_bf16", kind="flash", B=8, H=4, K=4, S=16,
         hd=32, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0, iters=200),
    # recurrentgemma-2b's windowed attention: 10 query heads over 1 KV head
    # of 256 (G = 10: one block takes all ten), a 3000-token prompt through
    # the 2048 window (the tensor-core body at hd 256), and a decode step
    # over the 2048-row ring written past its extent (16 spans of 128)
    dict(name="prefill_hybrid", kind="flash", B=1, H=10, K=1, S=3000,
         hd=256, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=2048,
         iters=3),
    dict(name="decode_hybrid_ring", kind="decode", B=8, H=10, K=1, S=2048,
         hd=256, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=2048,
         lengths=[2049 + 301 * b for b in range(8)], ring=True, iters=50),
    # paligemma-3b: 8 query heads over 1 KV head of 256, the serving shapes
    dict(name="prefill_paligemma", kind="flash", B=8, H=8, K=1, S=16,
         hd=256, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         iters=100),
    dict(name="decode_paligemma", kind="decode", B=8, H=8, K=1, S=128,
         hd=256, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=list(range(17, 33, 2)), ring=False, iters=200),
    dict(name="paged_paligemma", kind="paged", B=8, H=8, K=1, S=128, hd=256,
         bs=16, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=list(range(17, 33, 2)), iters=200),
    # whisper-medium's decoder self-attention: 16 heads of 64, MHA
    dict(name="decode_whisper", kind="decode", B=8, H=16, K=16, S=128,
         hd=64, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=list(range(17, 33, 2)), ring=False, iters=200),
    # disaggregated serving (stablelm-3b): one prompt per prefill call,
    # padded to 8 or 32 tokens, on the tensor-core body; a decode worker's
    # window at 8 slots over its 64-row pool, contiguous and paged (bs 16)
    dict(name="prefill_disagg_8", kind="flash", B=1, H=32, K=32, S=8,
         hd=80, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         iters=200),
    dict(name="prefill_disagg_32", kind="flash", B=1, H=32, K=32, S=32,
         hd=80, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         iters=200),
    dict(name="decode_disagg", kind="decode", B=8, H=32, K=32, S=64,
         hd=80, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=[9 + 7 * b for b in range(8)], ring=False, iters=200),
    dict(name="paged_disagg", kind="paged", B=8, H=32, K=32, S=64, hd=80,
         bs=16, qdt=torch.bfloat16, kvdt=torch.bfloat16, window=0,
         lengths=[9 + 7 * b for b in range(8)], iters=200),
]
# what these rows measured before the hd-256 bodies, printed beside this
# run's (``earlier``): each row's last record (PERF.md section 6 names
# the run it came from)
EARLIER = {
    "prefill_main": dict(ms=0.00569, plain_ms=0.0421, library_ms=0.01240,
                         bound_ms=0.000783),
    "decode_main_bf16q": dict(ms=0.00456, plain_ms=0.0730,
                              library_ms=0.01220, bound_ms=0.000613),
    "paged_main": dict(ms=0.00482, plain_ms=0.0833, library_ms=0.01217,
                       bound_ms=0.000613),
    "prefill_hybrid": dict(ms=4.527, plain_ms=3.380, library_ms=0.556,
                           bound_ms=0.0419),
    "decode_hybrid_ring": dict(ms=0.0832, plain_ms=0.1066, library_ms=0.0158,
                               bound_ms=0.00505),
    "prefill_paligemma": dict(ms=0.01885, plain_ms=0.0391, library_ms=0.01098,
                              bound_ms=0.000352),
    "decode_paligemma": dict(ms=0.00840, plain_ms=0.0300, library_ms=0.01154,
                             bound_ms=0.000079),
    "paged_paligemma": dict(ms=0.00852, plain_ms=0.0353, library_ms=0.01159,
                            bound_ms=0.000080),
    "paligemma_bf16": dict(ms=0.00850, plain_ms=0.0474, library_ms=0.01783,
                           bound_ms=0.000138),
}
# the rows of later slices' shapes, listed beside each kernel's main row
NEW_SHAPE_CASES = ("prefill_hybrid", "decode_hybrid_ring", "prefill_paligemma",
                   "decode_paligemma", "paged_paligemma", "decode_whisper",
                   "prefill_disagg_8", "prefill_disagg_32", "decode_disagg",
                   "paged_disagg")


def _paged_inputs(case, gen):
    """q, the k/v pool [1 + B*S/bs, bs, K, hd] with the trash block 0
    filled with 1e3 (a row read through a wrong entry is loud), a
    shuffled table mapping each slot's used blocks (trash past them),
    and a valid prefix of ``lengths[b]`` rows per slot."""
    B, H, K, S, hd, bs = (case[k] for k in ("B", "H", "K", "S", "hd", "bs"))
    mb = S // bs
    nb = 1 + B * mb
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(case["qdt"])
    pools = []
    for _ in range(2):
        x = torch.randn(nb, bs, K, hd, generator=gen, device="cuda")
        x[0] = 1e3
        pools.append(x.to(case["kvdt"]))
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(B, mb, dtype=torch.int32, device="cuda")
    lengths = torch.as_tensor(case["lengths"], device="cuda")
    for b, n in enumerate(case["lengths"]):
        used = -(-n // bs)
        table[b, :used] = perm[b * mb:b * mb + used].int()
    col = torch.arange(S, device="cuda")[None]
    kv_pos = torch.where(col < lengths[:, None], col, -1).to(torch.int32)
    cur = (lengths - 1).to(torch.int32)
    return q, pools[0], pools[1], table, kv_pos, cur


def _library_call(kind, q, k, v, mask, causal_square):
    """One ``scaled_dot_product_attention`` call computing the same
    function, or None where the inputs' types differ."""
    F = torch.nn.functional
    if q.dtype != k.dtype:
        return None
    gqa = q.shape[1] != k.shape[1]
    if kind == "flash":
        if causal_square:
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=gqa)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=gqa)
    q4 = q[:, :, None]
    m4 = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=m4, enable_gqa=gqa)[:, :, 0]


def phase_attention(peaks):
    """Each attention kernel on the card against its plain version, with
    times, bounds and the library yardstick; -> {kernel: summary}."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {"flash_attention": {"max_err": 0.0, "main": None},
           "decode_attention": {"max_err": 0.0, "main": None},
           "paged_decode_attention": {"max_err": 0.0, "main": None}}
    for case in ATTN_CASES:
        kind, B, H, K, S, hd = (case[k] for k in ("kind", "B", "H", "K",
                                                  "S", "hd"))
        window = case["window"]
        if kind == "flash":
            q = _bshd_views((B, H, S, hd), case["qdt"], gen)
            k = _bshd_views((B, K, S, hd), case["kvdt"], gen)
            v = _bshd_views((B, K, S, hd), case["kvdt"], gen)
            pos = torch.arange(S, device="cuda")
            mask = pos[None, :] <= pos[:, None]
            if window:
                mask &= pos[:, None] - pos[None, :] < window
            valid = int(mask.sum()) * B
            kern = lambda: fa_mod.flash_attention_cuda(  # noqa: E731
                q, k, v, window=window)
            plain = lambda: fa_mod.flash_attention_plain(  # noqa: E731
                q, k, v, window=window)
            lib = _library_call(kind, q, k, v, mask, window == 0)
            rows_ok = None
            name = "flash_attention"
        elif kind == "paged":
            q, kp, vp, tbl, kv_pos, cur = _paged_inputs(case, gen)
            mask = da_mod.valid_rows(kv_pos, cur, window)
            valid = int(mask.sum())
            rows_ok = mask.any(dim=1)
            kern = lambda: da_mod.paged_decode_attention_cuda(  # noqa: E731
                q, kp, vp, tbl, kv_pos, cur, window=window)
            plain = lambda: da_mod.paged_decode_attention_plain(  # noqa: E731
                q, kp, vp, tbl, kv_pos, cur, window=window)
            shim = lambda: da_mod.paged_decode_attention_shim(  # noqa: E731
                q, kp, vp, tbl, kv_pos, cur, window=window)
            kg, vg = da_mod.gather_block_views(kp, vp, tbl, S)
            lib = _library_call("decode", q, kg.transpose(1, 2),
                                vg.transpose(1, 2), mask, False)
            name = "paged_decode_attention"
        else:
            q = torch.randn(B, H, hd, generator=gen,
                            device="cuda").to(case["qdt"])
            k = _bshd_views((B, K, S, hd), case["kvdt"], gen)
            v = _bshd_views((B, K, S, hd), case["kvdt"], gen)
            kv_pos, cur = _decode_positions(B, S, case["lengths"],
                                            case["ring"])
            mask = da_mod.valid_rows(kv_pos, cur, window)
            valid = int(mask.sum())
            rows_ok = mask.any(dim=1)
            kern = lambda: da_mod.decode_attention_cuda(  # noqa: E731
                q, k, v, kv_pos, cur, window=window)
            plain = lambda: da_mod.decode_attention_plain(  # noqa: E731
                q, k, v, kv_pos, cur, window=window)
            lib = _library_call(kind, q, k, v, mask, False)
            name = "decode_attention"
        da_mod.combine_launches = da_mod.gqa_launches = 0
        got, want = kern(), plain()
        combines, gqa = da_mod.combine_launches, da_mod.gqa_launches
        if kind == "paged":
            fail_unless(torch.equal(got, shim()),
                        f"{case['name']}: paged kernel != gather shim")
        torch.cuda.synchronize()
        fail_unless(rows_ok is None or bool(rows_ok.all()),
                    f"{case['name']}: every slot has a valid row")
        fail_unless(bool(torch.isfinite(got.float()).all()),
                    f"{case['name']}: non-finite kernel output")
        err = (got.float() - want.float()).abs().max().item()
        row_err = row_scaled_error(got, want)
        f32 = case["qdt"] == case["kvdt"] == torch.float32
        tol = F32_TOL if f32 else BF16_TOL
        fail_unless(err <= tol, f"{case['name']}: kernel vs plain max abs "
                                f"err {err} > {tol}")
        # bf16: each row's error against that row's largest output, so
        # that a dropped key tile or span fails on small outputs too
        fail_unless(f32 or row_err <= ATTN_BF16_ROW_TOL,
                    f"{case['name']}: kernel vs plain row-scaled err "
                    f"{row_err} > {ATTN_BF16_ROW_TOL}")
        it = case["iters"]
        lib_ms, lib_err = None, None
        lib_what = "none: q and k/v types differ"
        if lib is not None:
            try:      # a yardstick: its failure fails nothing of the port
                lib_err = (lib().float() - want.float()).abs().max().item()
                time_ms(lib, 2)
                lib_ms = graph_ms(lib, it)
                lib_what = "scaled_dot_product_attention, same mask"
                if kind == "paged":
                    lib_what += (" (on the pre-gathered view: the "
                                 "gather is not in its time)")
            except Exception as e:
                lib_what = f"none: {type(e).__name__}: {e}"[:200]
        row = dict(phase="attention", kernel=name, case=case["name"],
                   B=B, H=H, K=K, S=S, hd=hd, window=window,
                   q_dtype=str(case["qdt"]).replace("torch.", ""),
                   kv_dtype=str(case["kvdt"]).replace("torch.", ""),
                   valid_pairs_or_rows=valid, max_abs_err=err, tol=tol,
                   row_scaled_err=row_err,
                   row_tol=None if f32 else ATTN_BF16_ROW_TOL,
                   ms=graph_ms(kern, it), call_ms=time_ms(kern, it),
                   plain_ms=graph_ms(plain, max(it // 4, 2)),
                   library_ms=lib_ms, library_computes=lib_what,
                   library_max_abs_err=lib_err)
        if kind == "flash":
            row["body"] = fa_mod.body(case["qdt"], case["kvdt"], hd)
            fail_unless(hd != 256 or f32 or row["body"] == "tensor_cores",
                        f"{case['name']}: bf16 at hd 256 on the tensor "
                        f"cores: {row['body']}")
        else:
            plan = da_mod.decode_span_plan(B, H, S, hd)
            fail_unless(combines == plan.combine,
                        f"{case['name']}: {combines} span merges for "
                        f"{plan.spans} spans")
            body = da_mod.decode_body(H, K, hd)
            fail_unless(gqa == (body == "gqa"),
                        f"{case['name']}: {gqa} GQA-body launches on the "
                        f"{body} body")
            row.update(spans=plan.spans, combine_launches=combines,
                       body=body, gqa_launches=gqa)
        if kind == "paged":
            row.update(bs=case["bs"], pool_blocks=kp.shape[0],
                       pool_bytes=2 * kp.numel() * kp.element_size(),
                       shim_equal=True, shim_ms=graph_ms(shim, it),
                       shim_call_ms=time_ms(shim, it))
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            kind, case, valid, peaks)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if case["name"] in EARLIER:
            row["earlier"] = EARLIER[case["name"]]
        emit(**row)
        out[name]["max_err"] = max(out[name]["max_err"], err)
        if case["name"] in ("prefill_main", "decode_main_bf16q",
                            "paged_main"):
            out[name]["main"] = row
        if case["name"].endswith("_granite"):
            out[name]["granite"] = row
        if case["name"] in NEW_SHAPE_CASES:
            out[name].setdefault("new_shapes", {})[case["name"]] = {
                k: row[k] for k in ("H", "K", "S", "hd", "window", "ms",
                                    "call_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "max_abs_err",
                                    "row_scaled_err")}
    # stablelm, granite, llama3 (G = 16, hd 128), the smoke configuration's
    # G = 4 at hd 16, recurrentgemma (G = 10, hd 256)
    for H, K, hd in ((32, 32, 80), (24, 8, 64), (128, 8, 128), (16, 4, 16),
                     (10, 1, 256)):
        phase_decode_invariance(gen, H, K, hd)
    return out


def phase_decode_invariance(gen, H, K, hd):
    """The serving decode case (8 slots, 17-31 valid rows, bf16) of H
    query heads over K KV heads of hd in a 128-row cache (one span) and
    with the same rows in a 4096-row cache whose other rows are empty
    (several spans, the span merge), both layouts (paged at bs 16): four
    results, equal byte for byte."""
    B, bs = 8, PAGED_BS
    lengths = list(range(17, 33, 2))
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(torch.bfloat16)
    rows = [torch.randn(B, 128, K, hd, generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2)]
    outs, spans = {}, {}
    for S in (128, 4096):
        kc, vc = (torch.zeros(B, S, K, hd, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        kc[:, :128], vc[:, :128] = rows
        kv_pos, cur = _decode_positions(B, S, lengths, ring=False)
        outs[f"contiguous_{S}"] = da_mod.decode_attention_cuda(
            q, kc.transpose(1, 2), vc.transpose(1, 2), kv_pos, cur)
        # the same logical rows in a pool of shuffled blocks
        mb = S // bs
        perm = torch.randperm(B * mb, generator=gen, device="cuda") + 1
        table = perm.reshape(B, mb).to(torch.int32)
        pools = []
        for x in (kc, vc):
            pool = torch.full((1 + B * mb, bs, K, hd), 1e3, device="cuda",
                              dtype=torch.bfloat16)
            pool[table.long()] = x.reshape(B, mb, bs, K, hd)
            pools.append(pool)
        outs[f"paged_{S}"] = da_mod.paged_decode_attention_cuda(
            q, pools[0], pools[1], table, kv_pos, cur)
        spans[S] = da_mod.decode_span_plan(B, H, S, hd).spans
    torch.cuda.synchronize()
    ref = outs["contiguous_128"]
    equal = {k: bool(torch.equal(v, ref)) for k, v in outs.items()}
    fail_unless(all(equal.values()), f"decode_invariance: {equal}")
    emit(phase="decode_invariance", B=B, H=H, K=K, hd=hd, bs=bs,
         valid_rows=lengths, spans=spans, equal_to_contiguous_128=equal)


def phase_serve_generate():
    """stablelm-3b at published width through the launcher; -> (launch
    counts over the run, the served model)."""
    args = serve.parser().parse_args(
        ["--device", "cuda", "--mode", "generate", "--arch", ARCH,
         "--requests", "32", "--new-tokens", "16", "--slots", "8",
         "--controller", "bio"])
    fa_mod.launches = 0
    da_mod.launches = da_mod.paged_launches = 0
    t0 = time.perf_counter()
    summary, server = serve.serve_generate(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"flash_attention": fa_mod.launches,
                "decode_attention": da_mod.launches}
    fail_unless(da_mod.paged_launches == 0,
                "generate: the contiguous pool runs no paged kernel")
    vocab = get_config(ARCH).vocab
    resp = server.responses
    fail_unless(sorted(r.rid for r in resp) == list(range(args.requests)),
                "generate: every request answered once")
    admitted = [r for r in resp if r.admitted]
    fail_unless(len(admitted) > 0, "generate: some request admitted")
    fail_unless(all(isinstance(r.output, list)
                    and 1 <= len(r.output) <= args.new_tokens
                    and all(0 <= t < vocab for t in r.output)
                    for r in admitted),
                "generate: 1..16 token ids inside the vocabulary each")
    fail_unless(all(n > 0 for n in launches.values()),
                f"generate: both attention kernels launched: {launches}")
    fail_unless(summary["window"] == "graph" and summary["captures"] == 1,
                f"generate: the window one captured graph: {summary}")
    model = server.engine.engine.params
    fail_unless(model.cfg.n_layers == 32 and model.cfg.d_model == 2560
                and model.emb.dtype == torch.bfloat16,
                "generate: published width, 32 layers, bf16")
    steps_run = summary["host_syncs"] * server.engine.engine.sync_every
    decode_s = summary["device_s"] - summary["prefill_s"]
    emit(phase="serve_generate", seconds=secs, launches=launches,
         admitted=len(admitted),
         tokens_per_busy_s=summary["tokens_generated"] / summary["busy_s"],
         decode_ms_per_step=decode_s / steps_run * 1e3,
         prefill_ms_per_call=(summary["prefill_s"]
                              / summary["prefill_calls"] * 1e3),
         **summary)
    return launches, model


def phase_serve_generate_smoke():
    """The launcher's generate run on the smoke configuration (hd 32, bf16:
    the flash kernel's CUDA-core body) on the card: every request
    answered, both attention kernels launched."""
    args = serve.parser().parse_args(
        ["--device", "cuda", "--mode", "generate", "--arch", ARCH, "--smoke",
         "--requests", "8"])
    fa_mod.launches = da_mod.launches = 0
    summary, server = serve.serve_generate(args)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa_mod.launches,
                "decode_attention": da_mod.launches}
    fail_unless(sorted(r.rid for r in server.responses)
                == list(range(args.requests)),
                "generate --smoke: every request answered once")
    fail_unless(all(n > 0 for n in launches.values()),
                f"generate --smoke: both attention kernels launched: "
                f"{launches}")
    cfg = server.engine.engine.params.cfg
    emit(phase="serve_generate_smoke", head_dim=cfg.head_dim,
         flash_body=fa_mod.body(torch.bfloat16, torch.bfloat16, cfg.head_dim),
         launches=launches, tokens_generated=summary["tokens_generated"])


def _greedy_lockstep(model, prompts, n_new, dtype=torch.float32, **inputs):
    """Lockstep greedy decode, by default over an f32 cache (no bf16
    rounding of the keys, so the card and the CPU can agree token for
    token), after a prefill given ``inputs`` (``prefix_embeds``, which
    shift every position by their length, or ``enc_embeds``); -> (the
    prefill's logits [B, 1, V], the tokens [B, n_new], the logits each
    token was chosen from [B, n_new, V]), on the CPU."""
    B, S = prompts.shape
    pre = inputs.get("prefix_embeds")
    S += 0 if pre is None else pre.shape[1]
    cache = tfm.init_cache(model.cfg, B, S + n_new, dtype,
                           device=model.device)
    inputs = {k: torch.as_tensor(v).to(model.device)
              for k, v in inputs.items()}
    logits, cache = model.prefill(prompts, cache, **inputs)
    first = logits
    tok = logits[:, -1].argmax(-1)[:, None]
    out, seen = [], []
    for i in range(n_new):
        out.append(tok[:, 0])
        seen.append(logits[:, -1].float().cpu())
        logits, cache = model.decode_step(tok, cache, S + i)
        tok = logits[:, -1].argmax(-1)[:, None]
    return (first.float().cpu(), torch.stack(out, 1).cpu(),
            torch.stack(seen, 1))


def phase_parity_generate(model):
    cfg = get_config(ARCH)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (8, 16)).astype(np.int32)
    # published width, depth 2, f32: card (kernel path) vs CPU (einsum)
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    m_gpu = tfm.init_lm(cfg2, 0, device="cuda")
    m_cpu = tfm.LM(cfg2, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    fa_mod.launches = da_mod.launches = 0
    lg, tg, _ = _greedy_lockstep(m_gpu, prompts, 8)
    fail_unless(fa_mod.launches > 0 and da_mod.launches > 0,
                "parity: the card's run went through both kernels")
    lc, tc, _ = _greedy_lockstep(m_cpu.eval(), prompts, 8)
    err = (lg - lc).abs().max().item()
    fail_unless(bool(torch.isfinite(lg).all()) and err <= LOGITS_TOL,
                f"depth-2 f32 prefill logits card vs CPU: {err}")
    fail_unless(torch.equal(tg, tc), "depth-2 f32 greedy tokens card vs CPU")
    del m_gpu, m_cpu
    # the served model, full depth, bf16: kernels vs the einsum path
    res = {}
    for impl in ("auto", "xla"):
        model.attn_impl = impl
        c = tfm.init_cache(model.cfg, 8, 128, device="cuda")
        logits, _ = model.prefill(prompts, c)
        toks = GenerationEngine(model.cfg, model, max_seq=128,
                                device="cuda").generate(prompts, 16)
        res[impl] = (logits.float(), toks)
    model.attn_impl = "auto"
    full_err = (res["auto"][0] - res["xla"][0]).abs().max().item()
    fail_unless(bool(torch.isfinite(res["auto"][0]).all()),
                "full-depth bf16 logits finite")
    agree = float((res["auto"][1] == res["xla"][1]).mean())
    emit(phase="parity_generate",
         depth2_f32_prefill_logits_card_vs_cpu_max_abs_err=err,
         depth2_f32_greedy_tokens_equal=True,
         full_bf16_prefill_logits_kernel_vs_xla_max_abs_err=full_err,
         full_bf16_greedy_token_agreement=agree,
         full_bf16_first_tokens_equal=bool(
             (res["auto"][1][:, 0] == res["xla"][1][:, 0]).all()))


def _profile_step(step, attention="decode_kernel"):
    """Kernels and device time of one call, by the profiler, split by
    name into the attention kernel (names holding ``attention``),
    matrix products and the rest; None where the profiler records no
    device time here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    parts = {"attention": 0.0, "products": 0.0, "rest": 0.0}
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "device_time", None)
        if t is None:
            t = getattr(e, "cuda_time", 0.0)
        name = e.name.lower()
        if attention in name:
            parts["attention"] += t / 1e3
        elif any(w in name for w in ("gemm", "gemv", "cutlass", "xmma",
                                     "nvjet", "splitk")):
            parts["products"] += t / 1e3
        else:
            parts["rest"] += t / 1e3
        cnt = by_name.setdefault(e.name[:60], [0, 0.0])
        cnt[0] += 1
        cnt[1] += t / 1e3
    n = sum(c for c, _ in by_name.values())
    if n == 0 or sum(parts.values()) == 0.0:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(kernels=n, **{f"{k}_ms": v for k, v in parts.items()},
                top=[[name, c, ms] for name, (c, ms) in top])


def phase_breakdown_generate(model, peaks):
    """One decode step at 8 slots of the served model: its device time
    (graph replay) and its time issued from Python, split into the
    attention kernels, the products and the rest, beside the step's
    weight-bytes bound."""
    cfg = model.cfg
    B = 8
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B, 16))
    cache = tfm.init_cache(cfg, B, 128, device="cuda")
    model.prefill(prompts, cache)
    tok = torch.zeros(B, 1, dtype=torch.long, device="cuda")
    pos = torch.full((B,), 16, dtype=torch.long, device="cuda")

    def step():
        model.decode_step(tok, cache, pos)

    step_call = time_ms(step, 10)
    step_dev = graph_ms(step, 1, replays=10)
    kv = cache.layer(0)
    q = torch.randn(B, cfg.n_heads, cfg.head_dim, device="cuda").to(
        torch.bfloat16)
    cur = pos.to(torch.int32)
    attn = graph_ms(lambda: da_mod.decode_attention_cuda(
        q, kv.k.transpose(1, 2), kv.v.transpose(1, 2), kv.pos, cur),
        50) * cfg.n_layers
    x = torch.randn(B, 1, cfg.d_model, device="cuda").to(torch.bfloat16)
    g = torch.randn(B, 1, cfg.d_ff, device="cuda").to(torch.bfloat16)

    def products():
        for layer in model.layers:
            p, m = layer.mix, layer.mlp
            x @ p.wq, x @ p.wk, x @ p.wv, x @ p.wo
            x @ m.w_gate, x @ m.w_up, g @ m.w_down
        x @ model.unemb

    prod = graph_ms(products, 1, replays=10)
    wbytes = sum(t.numel() * t.element_size() for t in model.parameters())
    try:
        prof = _profile_step(step)
    except Exception as e:          # the profiler is untried on the card
        prof = {"error": repr(e)[:200]}
    emit(phase="breakdown_generate", slots=B, layers=cfg.n_layers,
         step_ms=step_dev, step_call_ms=step_call,
         device_busy_share_of_call=step_dev / step_call,
         attention_ms=attn, products_ms=prod,
         rest_ms=step_dev - attn - prod,
         weight_bytes=wbytes, weight_bytes_bound_ms=wbytes / peaks["hbm"] * 1e3,
         profiler=prof if prof is not None else "no device time recorded")
    # the same step over a paged pool: each slot maps 8 blocks of 16 rows,
    # the first 16 rows valid (the prompt), as the paged serve phase holds
    pcfg = cfg.replace(kv_block_size=PAGED_BS)
    pool = tfm.init_cache(pcfg, B, 128, device="cuda")
    mb = pool.block_table.shape[1]
    pool.block_table.copy_(1 + torch.arange(B * mb, device="cuda").reshape(
        B, mb).to(torch.int32))
    pool.pos[:, :, :16] = torch.arange(16, device="cuda", dtype=torch.int32)

    def paged_step():
        model.decode_step(tok, pool, pos)

    paged_call = time_ms(paged_step, 10)
    paged_dev = graph_ms(paged_step, 1, replays=10)
    try:
        pprof = _profile_step(paged_step)
    except Exception as e:          # the profiler is untried on the card
        pprof = {"error": repr(e)[:200]}
    emit(phase="breakdown_generate_paged", slots=B, layers=cfg.n_layers,
         bs=PAGED_BS, step_ms=paged_dev, step_call_ms=paged_call,
         device_busy_share_of_call=paged_dev / paged_call,
         contiguous_step_ms=step_dev, contiguous_step_call_ms=step_call,
         profiler=pprof if pprof is not None else "no device time recorded")


PAGED_BS, PAGED_POOL = 16, 13      # 12 allocatable blocks of 16 rows
LONG_PROMPT, LONG_MAX_SEQ = 2048, 2064


def phase_prefill_long_generate(model):
    """One 2048-token prompt through the served stablelm-3b (full width,
    32 layers, bf16) into a contiguous cache of 2064 rows (676 MB of
    K/V): the prefill's time from the host around a synchronised call
    after a warm one, its flash launches, flash's share of its device
    time, and the first 8 greedy tokens against ``attn_impl="xla"``
    (printed, not checked: full-depth bf16 differs by rounding)."""
    cfg = model.cfg
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab, (1, LONG_PROMPT)).astype(np.int32)
    cache = tfm.init_cache(cfg, 1, LONG_MAX_SEQ, device="cuda")
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in (cache.layer(0).k, cache.layer(0).v)) * cfg.n_layers

    def prefill():
        return model.prefill(prompt, cache)

    prefill()
    torch.cuda.synchronize()
    fa_mod.launches = 0
    t0 = time.perf_counter()
    logits, _ = prefill()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = fa_mod.launches
    fail_unless(launches == cfg.n_layers,
                f"long prefill: {launches} flash launches, one per layer")
    fail_unless(bool(torch.isfinite(logits.float()).all()),
                "long prefill: finite logits")
    try:
        prof = _profile_step(prefill, attention="flash_tc_kernel")
    except Exception as e:          # the profiler is untried on the card
        prof = {"error": repr(e)[:200]}
    toks = {}
    for impl in ("auto", "xla"):
        model.attn_impl = impl
        toks[impl] = GenerationEngine(cfg, model, max_seq=LONG_MAX_SEQ,
                                      device="cuda").generate(prompt, 8)
    model.attn_impl = "auto"
    agree = float((toks["auto"] == toks["xla"]).mean())
    device_ms = (None if prof is None or "error" in prof else
                 prof["attention_ms"] + prof["products_ms"] + prof["rest_ms"])
    emit(phase="prefill_long_generate", prompt_tokens=LONG_PROMPT,
         max_seq=LONG_MAX_SEQ, kv_cache_bytes=kv_bytes, prefill_ms=ms,
         flash_launches=launches,
         flash_device_share=(prof["attention_ms"] / device_ms if device_ms
                             else prof or "no device time recorded"),
         flash_device_ms=prof["attention_ms"] if device_ms else None,
         device_ms=device_ms,
         greedy_tokens_kernel=np.asarray(toks["auto"]).tolist(),
         greedy_tokens_xla=np.asarray(toks["xla"]).tolist(),
         greedy_token_agreement_vs_xla=agree)


def phase_serve_generate_paged():
    """The launcher's generate run on the paged pool; -> the paged
    kernel's launches over the run."""
    args = serve.parser().parse_args(
        ["--device", "cuda", "--mode", "generate", "--arch", ARCH,
         "--requests", "32", "--new-tokens", "16", "--slots", "8",
         "--controller", "bio", "--kv-block-size", str(PAGED_BS),
         "--kv-pool-blocks", str(PAGED_POOL)])
    fa_mod.launches = 0
    da_mod.launches = da_mod.paged_launches = 0
    t0 = time.perf_counter()
    summary, server = serve.serve_generate(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"flash_attention": fa_mod.launches,
                "paged_decode_attention": da_mod.paged_launches,
                "decode_attention": da_mod.launches}
    vocab = get_config(ARCH).vocab
    resp = server.responses
    fail_unless(sorted(r.rid for r in resp) == list(range(args.requests)),
                "paged: every request answered once")
    admitted = [r for r in resp if r.admitted]
    fail_unless(len(admitted) > 0 and all(
        isinstance(r.output, list) and 1 <= len(r.output) <= args.new_tokens
        and all(0 <= t < vocab for t in r.output) for r in admitted),
        "paged: 1..16 token ids inside the vocabulary each")
    fail_unless(launches["paged_decode_attention"] > 0
                and launches["flash_attention"] > 0,
                f"paged: flash and paged decode kernels launched: {launches}")
    fail_unless(launches["decode_attention"] == 0,
                f"paged: the contiguous decode kernel (the shim's) was not "
                f"the serving path: {launches}")
    fail_unless(summary["window"] == "graph" and summary["captures"] == 1,
                f"paged: the window one captured graph: {summary}")
    fail_unless(summary["mode"] == "paged"
                and summary["blocks_allocated"] == summary["blocks_freed"]
                and summary["free_blocks"] == PAGED_POOL - 1,
                f"paged: every block given back: {summary}")
    fail_unless(summary["peak_blocks_in_use"] <= PAGED_POOL - 1
                and summary["occupancy"] <= 0.75,
                f"paged: at most 12 blocks, 6 of 8 slots: {summary}")
    cfg = serve.generate_config(args)
    steps_run = summary["host_syncs"] * server.engine.engine.sync_every
    decode_s = summary["device_s"] - summary["prefill_s"]
    emit(phase="serve_generate_paged", seconds=secs, launches=launches,
         admitted=len(admitted),
         tokens_per_busy_s=summary["tokens_generated"] / summary["busy_s"],
         decode_ms_per_step=decode_s / steps_run * 1e3,
         prefill_ms_per_call=(summary["prefill_s"]
                              / summary["prefill_calls"] * 1e3),
         pool_hbm_bytes={
             "paged": cont.pool_hbm_bytes(cfg, args.slots,
                                          serve.GEN_MAX_SEQ),
             "contiguous": cont.pool_hbm_bytes(
                 cfg.replace(kv_block_size=0, kv_pool_blocks=0),
                 args.slots, serve.GEN_MAX_SEQ)},
         **summary)
    return launches["paged_decode_attention"]


def _drive(engine, reqs, prompt_len, waves=None):
    """Run ``reqs`` through a fresh session: all queued at once, or,
    given ``waves`` (the rids another run seated at each advance), each
    pushed just before the advance that seated it there.  -> (session,
    the rids seated at each advance, refills that left a request queued
    while a slot was free: it waited for blocks)."""
    sess = engine.start_session(prompt_len)
    by_rid = {r.rid: r for r in reqs}
    if waves is None:
        for r in reqs:
            sess.push(r)
    seated, waits = [], 0
    while not sess.idle or (waves is not None and len(seated) < len(waves)):
        if waves is not None and len(seated) < len(waves):
            for rid in waves[len(seated)]:
                sess.push(by_rid[rid])
        queued = [r.rid for r in sess.queue]
        free = engine.n_slots - sess.n_active
        sess.advance()
        left = {r.rid for r in sess.queue}
        seated.append([rid for rid in queued if rid not in left])
        waits += len(seated[-1]) < min(free, len(queued))
    return sess, seated, waits


def phase_parity_paged(model):
    """The served model (full width, bf16) on one trace through the
    paged and the contiguous engine, no controller: the same tokens for
    every request.  12 prompts of 4-16 tokens padded to 16, budgets of
    2-30 tokens, an EOS for request 5 taken from a first paged run, and
    an 11-block pool (10 allocatable: 3 to 5 requests at a time, so
    requests wait for blocks).  cuBLAS picks its products by their row
    count, so one prompt prefilled in waves of different sizes may round
    differently in bf16: the contiguous engine therefore replays the
    paged run's waves (each request pushed just before the advance that
    seated it there), which it can only seat the same way if every
    token so far was equal.  A contiguous run with the whole queue
    pushed at once is reported beside it, not checked."""
    cfg = model.cfg
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 17, size=12)]
    budgets = [int(n) for n in rng.integers(2, 31, size=12)]

    def trace(eos=None):
        return [cont.GenRequest(rid=i, prompt=p, max_new=m,
                                eos_id=(eos or {}).get(i))
                for i, (p, m) in enumerate(zip(prompts, budgets))]

    contiguous = cont.ContinuousBatchingEngine(cfg, model, n_slots=8,
                                               max_seq=128, device="cuda")
    paged = cont.ContinuousBatchingEngine(
        cfg.replace(kv_block_size=PAGED_BS, kv_pool_blocks=11), model,
        n_slots=8, max_seq=128, device="cuda")
    probe = trace()
    _drive(paged, probe, 16)
    g5 = probe[5].generated
    eos = {5: next((t for j, t in enumerate(g5) if j and t not in g5[:j]),
                   g5[0])}
    t0 = time.perf_counter()
    da_mod.launches = da_mod.paged_launches = 0
    rp = trace(eos)
    sp, waves, waits = _drive(paged, rp, 16)
    paged_launches = (da_mod.launches, da_mod.paged_launches)
    da_mod.launches = da_mod.paged_launches = 0
    rc = trace(eos)
    sc, waves_c, _ = _drive(contiguous, rc, 16, waves)
    contiguous_launches = (da_mod.launches, da_mod.paged_launches)
    secs = time.perf_counter() - t0
    free_run = trace(eos)
    _drive(contiguous, free_run, 16)
    fail_unless(contiguous_launches[0] > 0 and contiguous_launches[1] == 0
                and paged_launches[0] == 0 and paged_launches[1] > 0,
                f"parity_paged: each engine ran its own decode kernel: "
                f"{contiguous_launches}, {paged_launches}")
    fail_unless(waves_c == waves, f"parity_paged: the contiguous engine "
                                  f"seated the paged run's waves: {waves}, "
                                  f"{waves_c}")
    same = [a.generated == b.generated for a, b in zip(rc, rp)]
    fail_unless(all(r.done for r in rc + rp) and all(same),
                f"parity_paged: tokens per request equal: {same}")
    fail_unless(waits > 0, "parity_paged: a request waited for blocks")
    fail_unless(rp[5].generated.index(eos[5]) == len(rp[5].generated) - 1,
                "parity_paged: request 5 stopped on its EOS")
    st = sp.stats()
    fail_unless(st["blocks_allocated"] == st["blocks_freed"]
                and st["peak_blocks_in_use"] <= 10,
                f"parity_paged: blocks balanced: {st}")
    emit(phase="parity_paged", seconds=secs, requests=len(rp),
         tokens=sum(len(r.generated) for r in rp), tokens_equal=True,
         waves=[w for w in waves if w], waits=waits,
         eos_stop_len=len(rp[5].generated),
         contiguous_decode_launches=contiguous_launches[0],
         paged_decode_launches=paged_launches[1],
         contiguous_whole_queue_requests_equal=sum(
             a.generated == b.generated for a, b in zip(free_run, rp)),
         **st)


# ---------------------------------------------------------------------------
# disaggregated serving: prefill -> transfer -> insert -> generate
# ---------------------------------------------------------------------------

DISAGG_REQUESTS = 48
DISAGG_PROMPT_LEN = 16


def _disagg_trace(vocab: int, n: int = 12, seed: int = 6):
    """-> a maker of ``n`` requests: prompts of 4-16 tokens (padded to
    ``DISAGG_PROMPT_LEN``), budgets of 2-30 tokens, EOS ids by rid."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, int(k)).astype(np.int32)
               for k in rng.integers(4, 17, size=n)]
    budgets = [int(m) for m in rng.integers(2, 31, size=n)]
    return lambda eos=None: [
        cont.GenRequest(rid=i, prompt=p, max_new=m,
                        eos_id=(eos or {}).get(i))
        for i, (p, m) in enumerate(zip(prompts, budgets))]


def _split(eng, reqs, prompt_len, session=None):
    """``reqs`` through the split-phase API: each prefilled at batch 1
    and inserted, then the decode session advanced dry."""
    sess = session or eng.start_session()
    for r in reqs:
        eng.insert(eng.prefill(r, prompt_len=prompt_len), sess)
    while not sess.idle:
        eng.generate(sess)
    return sess


def _one_per_wave(engine, reqs, prompt_len):
    """``reqs`` through a pooled session, each pushed only once the
    queue is empty, so every refill wave prefills ONE prompt: its
    products run at M = plen rows, as a disaggregated prefill's do
    (cuBLAS may pick another algorithm for another M, and bf16 then
    rounds differently)."""
    sess = engine.start_session(prompt_len)
    pending = list(reqs)
    while pending or not sess.idle:
        if pending and not sess.queue:
            sess.push(pending.pop(0))
        sess.advance()
    return sess


def _first_divergence(a, b):
    for r, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if u != v:
                return {"rid": r, "token": j}
        if len(x) != len(y):
            return {"rid": r, "token": min(len(x), len(y))}
    return None


def phase_disagg_parity(model):
    """The served model (stablelm-3b, full width, bf16) through the
    split-phase engine, 12 requests over 8 slots (an EOS for request 5,
    taken from a first run), contiguous and paged (bs 16): the tokens
    byte-equal to a pooled session fed one request per wave, each
    layout's decode kernel launched; beside it, printed only, the
    agreement with the pooled session fed the whole queue at once
    (waves of up to 8).  Then insert-after-capture: 4 requests run dry
    in a session (its window captured), 8 more inserted into it and
    replayed, their tokens equal to an uncaptured engine's."""
    cfg = model.cfg
    mk = _disagg_trace(cfg.vocab)
    lines = {}
    for layout, kw in (("contiguous", {}),
                       ("paged", {"kv_block_size": PAGED_BS})):
        c = cfg.replace(**kw)
        dis = DisaggEngine.build(c, model, n_slots=8,
                                 max_seq=serve.DISAGG_MAX_SEQ,
                                 device="cuda")
        pooled = cont.ContinuousBatchingEngine(
            c, model, n_slots=8, max_seq=serve.DISAGG_MAX_SEQ,
            device="cuda")
        probe = mk()
        _split(dis, probe, DISAGG_PROMPT_LEN)
        g5 = probe[5].generated
        eos = {5: next((t for j, t in enumerate(g5) if j and t not in g5[:j]),
                       g5[0])}
        t0 = time.perf_counter()
        _zero_counters()
        rs = mk(eos)
        ss = _split(dis, rs, DISAGG_PROMPT_LEN)
        launches = _attention_launches()
        rp = mk(eos)
        sp = _one_per_wave(pooled, rp, DISAGG_PROMPT_LEN)
        secs = time.perf_counter() - t0
        same = [a.generated == b.generated for a, b in zip(rs, rp)]
        fail_unless(all(r.done for r in rs + rp) and all(same),
                    f"disagg {layout}: tokens byte-equal to the pooled "
                    f"one-per-wave run: {same}")
        fail_unless(sp.prefill_calls == len(rp),
                    f"disagg {layout}: one prompt per pooled wave")
        fail_unless(ss.insert_calls == len(rs)
                    and rs[5].generated[-1] == eos[5],
                    f"disagg {layout}: every request inserted "
                    f"({ss.insert_calls}), request 5 stopped on its EOS")
        own = "paged_decode_attention" if kw else "decode_attention"
        other = "decode_attention" if kw else "paged_decode_attention"
        fail_unless(launches["flash_attention"] == len(rs)
                    * cfg.n_layers and launches[own] > 0
                    and launches[other] == 0,
                    f"disagg {layout}: batch-1 flash prefills and the "
                    f"layout's decode kernel: {launches}")
        st = ss.stats()
        kinds = len(dis.decode.decode_captures)
        fail_unless(st["window"] == "graph" and st["captures"] == kinds,
                    f"disagg {layout}: every window kind captured when "
                    f"the session was made, none after: {st}")
        if kw:
            fail_unless(st["blocks_allocated"] == st["blocks_freed"]
                        and st["free_blocks"] == dis.decode.pool_blocks - 1,
                        f"disagg paged: every block given back: {st}")
        rw = mk(eos)
        _drive(pooled, rw, DISAGG_PROMPT_LEN)
        waves_same = sum(a.generated == b.generated for a, b in zip(rw, rs))
        # insert after capture
        ra, rb = mk()[:4], mk()[4:]
        cs = _split(dis, ra, DISAGG_PROMPT_LEN)
        fail_unless(cs.captures == kinds, "disagg: the windows captured")
        syncs = cs.host_syncs
        _split(dis, rb, DISAGG_PROMPT_LEN, session=cs)
        eager = DisaggEngine.build(c, model, n_slots=8,
                                   max_seq=serve.DISAGG_MAX_SEQ,
                                   device="cuda", capture=False)
        ua, ub = mk()[:4], mk()[4:]
        es = _split(eager, ua, DISAGG_PROMPT_LEN)
        _split(eager, ub, DISAGG_PROMPT_LEN, session=es)
        after = [a.generated == b.generated for a, b in zip(rb, ub)]
        fail_unless(all(after) and cs.captures == kinds
                    and es.captures == 0 and cs.host_syncs > syncs,
                    f"disagg {layout}: inserted after the capture, the "
                    f"replayed window's tokens equal the uncaptured "
                    f"engine's: {after}")
        lines[layout] = dict(
            seconds=secs, requests=len(rs),
            tokens=sum(len(r.generated) for r in rs),
            tokens_equal_one_per_wave=True, launches=launches,
            insert_calls=st["insert_calls"], captures=st["captures"],
            pooled_waves_requests_equal=waves_same,
            pooled_waves_first_divergence=_first_divergence(
                [r.generated for r in rw], [r.generated for r in rs]),
            insert_after_capture_requests_equal=len(after),
            insert_after_capture_windows=cs.host_syncs - syncs,
            **({k: st[k] for k in ("blocks_allocated", "blocks_freed",
                                   "peak_blocks_in_use")} if kw else {}))
        del dis, pooled, eager, cs, es, ss, sp
    emit(phase="disagg_parity", n_layers=cfg.n_layers, d_model=cfg.d_model,
         dtype=str(model.emb.dtype), **lines)
    torch.cuda.empty_cache()


def phase_disagg_parity_f32():
    """The reference's own trace (``tests/test_disagg.py``: 6 requests of
    8 tokens, budgets 3-5, over 3 slots, sync every 4, max_seq 64) at
    published width, depth 2, f32 weights, contiguous and paged (bs 8):
    split-phase tokens on the card equal the pooled engine's (waves of 3)
    on the card and the split-phase tokens on the CPU."""
    cfg2 = get_config(ARCH).replace(n_layers=2, dtype="float32")
    m_gpu, m_cpu = _card_and_cpu(cfg2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg2.vocab, 8) for _ in range(6)]

    def mk():
        return [cont.GenRequest(rid=i, prompt=prompts[i],
                                max_new=3 + (i % 3)) for i in range(6)]

    out = {}
    for layout, kw in (("contiguous", {}), ("paged", {"kv_block_size": 8})):
        c = cfg2.replace(**kw)
        toks = {}
        for where, m in (("card", m_gpu), ("cpu", m_cpu)):
            eng = DisaggEngine.build(c, m, n_slots=3, max_seq=64,
                                     sync_every=4, device=m.device)
            rs = mk()
            _split(eng, rs, 8)
            toks[where] = [r.generated for r in rs]
        rp = mk()
        cont.ContinuousBatchingEngine(c, m_gpu, n_slots=3, max_seq=64,
                                      sync_every=4, device="cuda").serve(
            rp, prompt_len=8)
        toks["pooled"] = [r.generated for r in rp]
        fail_unless(toks["card"] == toks["pooled"] == toks["cpu"],
                    f"disagg depth-2 f32 {layout}: split on the card == "
                    f"pooled (waves of 3) == split on the CPU: {toks}")
        out[layout] = {"tokens_equal": True,
                       "tokens": sum(len(t) for t in toks["card"])}
    emit(phase="disagg_parity_f32", n_layers=2, dtype="float32", **out)
    del m_gpu, m_cpu
    torch.cuda.empty_cache()


def _spans(trace_path: str, name: str) -> list:
    with open(trace_path) as f:
        d = json.load(f)
    ev = d["traceEvents"] if isinstance(d, dict) else d
    return [e for e in ev if e.get("name") == name and e.get("ph") == "X"]


def _disagg_run(tag: str, flags: list[str], idle_w: float) -> dict:
    """One ``--fleet-disagg`` run through the launcher's own flags at
    published width (48 requests, 2 prefill and 2 decode workers, 8
    slots a decode worker), its trace and metrics written and
    validated, the card's energy counter read around it, the attention
    kernels' launches counted from just after the fleet is built and
    warmed (``serve.build_disagg``) to just after the run; the warm-up's
    own launches printed apart."""
    out_dir = os.path.join(ROOT, "build", "chip_smoke_disagg")
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, f"{tag}.trace.json")
    metrics = os.path.join(out_dir, f"{tag}.metrics.json")
    args = serve.parser().parse_args(
        ["--device", "cuda", "--fleet-disagg", "--arch", ARCH,
         "--requests", str(DISAGG_REQUESTS), "--prefill-workers", "2",
         "--decode-workers", "2", "--runs",
         os.path.join(ROOT, "build", "chip_smoke_runs"),
         "--trace-out", trace, "--metrics-out", metrics,
         "--energy-source", "nvml", *flags])
    _zero_counters()
    t0 = time.perf_counter()
    built = serve.build_disagg(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm_launches = _attention_launches()
    _zero_counters()
    t0 = time.perf_counter()
    out, report, pool = serve.serve_disagg(args, built)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _attention_launches()
    paged = args.kv_block_size > 0
    n = args.requests
    rids = [r["rid"] for r in report.responses]
    fail_unless(sorted(rids) == list(range(n)),
                f"disagg {tag}: every request answered exactly once")
    fail_unless(out["n_served"] == n and out["n_rejected"] == 0,
                f"disagg {tag}: every request served, none rejected")
    vocab = pool.prefill_workers[0].engine.cfg.vocab
    fail_unless(all(1 <= len(r["tokens"]) and all(0 <= t < vocab
                                                  for t in r["tokens"])
                    for r in report.responses),
                f"disagg {tag}: token ids inside the vocabulary")
    fail_unless(out["n_layers"] == 32 and out["d_model"] == 2560,
                f"disagg {tag}: published width")
    kinds = len(pool.decode_workers[0].engine.decode_captures)
    fail_unless(all(c["captures"] == kinds
                    for c in out["captures"].values()),
                f"disagg {tag}: each decode session captured every window "
                f"kind when it was built and none in the run: "
                f"{out['captures']}")
    fail_unless(validate_main([trace, metrics, "--require-gauge",
                               "compile_seconds", "energy_drift_ratio",
                               "fleet_pressure"]) == 0,
                f"disagg {tag}: trace and metrics validate")
    own = "paged_decode_attention" if paged else "decode_attention"
    other = "decode_attention" if paged else "paged_decode_attention"
    fail_unless(launches["flash_attention"] > 0 and launches[own] > 0
                and launches[other] == 0,
                f"disagg {tag}: flash and the layout's decode kernel "
                f"launched: {launches}")
    drift = out["energy_drift"]
    fail_unless(drift["source"] == "nvml" and drift["measured_j"] > 0,
                f"disagg {tag}: the card's energy counter read {drift}")
    pre = _spans(trace, "prefill")
    by_plen = {}
    for e in pre:
        by_plen.setdefault(e["args"]["plen"], []).append(e["dur"] / 1e3)
    win = [e["dur"] / 1e3 for e in _spans(trace, "decode.window")]
    lat = np.array([r["latency_s"] for r in report.responses])
    line = dict(
        phase="disagg", run=tag, scenario=out["scenario"], requests=n,
        kv_block_size=args.kv_block_size, n_layers=out["n_layers"],
        n_served=out["n_served"], n_rejected=out["n_rejected"],
        p50_latency_ms=float(np.percentile(lat, 50)) * 1e3,
        p95_latency_ms=float(np.percentile(lat, 95)) * 1e3,
        span_s=out["span_s"], wall_s=wall_s, build_and_warm_s=build_s,
        busy_s={k: v["busy_s"] for k, v in out["per_worker"].items()},
        served_by={k: v["n_served"] for k, v in out["per_worker"].items()},
        transfers=out["transfer"]["n_transfers"],
        transfer_bytes=out["transfer"]["total_bytes"],
        prefill_ms_by_plen={p: {"calls": len(v),
                                "mean_ms": float(np.mean(v)),
                                "median_ms": float(np.median(v))}
                            for p, v in sorted(by_plen.items())},
        decode_windows=len(win),
        decode_ms_per_window={"mean": float(np.mean(win)),
                              "median": float(np.median(win)),
                              "max": float(np.max(win))},
        captures=out["captures"],
        compile_capture_count=drift["compile"]["capture_count"],
        compile_capture_s=drift["compile"]["capture_seconds"],
        modelled_j=out["energy_j"], nvml_j=drift["measured_j"],
        nvml_window_s=drift["window_s"], drift_ratio=drift["drift_ratio"],
        idle_power_w=idle_w, idle_j_in_window=idle_w * drift["window_s"],
        launches=launches, warm_launches=warm_launches)
    emit(**line)
    del pool, report
    torch.cuda.empty_cache()
    return launches


def phase_disagg_chaos(model):
    """The decode-crash plus link-flap story at published width: 24
    ``prompt-burst`` requests over 2 prefill and 2 decode workers, the
    reference's fault plan (``decode-0`` crashes and the link flaps
    mid-run): every rid resolved exactly once, the crashed worker's new
    session capturing again, and the old pool freed (device memory back
    where it was once the run is over)."""
    from repro_torch.faults import (FaultEvent, FaultInjector, FaultPlan,
                                    RetryPolicy)
    from repro_torch.fleet import make_generate_scenario
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    pool = build_disagg_fleet(model.cfg, model, n_prefill=2, n_decode=2,
                              n_slots=8, max_seq=serve.DISAGG_MAX_SEQ,
                              energy_model=serve.device_energy_model(
                                  model.device), device="cuda")
    sc = make_generate_scenario("prompt-burst", 24, qps=40.0, seed=0,
                                vocab=model.cfg.vocab)
    mid = sc.requests[len(sc.requests) // 2].arrival_s
    plan = FaultPlan.scripted([
        FaultEvent(t=mid, kind="crash", target="decode-0", duration_s=0.2),
        FaultEvent(t=mid, kind="link-flap", duration_s=0.05)])
    first = weakref.ref(pool.decode_workers[0].session)
    t0 = time.perf_counter()
    rep = DisaggSimulator(pool, router=PhaseAwareRouter(),
                          injector=FaultInjector(plan),
                          retry_policy=RetryPolicy()).run(sc.requests)
    secs = time.perf_counter() - t0
    rids = [r["rid"] for r in rep.responses]
    fail_unless(sorted(rids) == list(range(24)) and len(set(rids)) == 24,
                "disagg chaos: every rid resolved exactly once")
    s = rep.summary
    fail_unless(s["n_served"] + s["n_rejected"] == 24
                and s["n_failures"] == 2
                and s["n_retries"] + s["n_retransmits"] > 0,
                f"disagg chaos: crash and flap injected, retried: {s}")
    fail_unless(all("rejected" in r or len(r["tokens"]) >= 1
                    for r in rep.responses),
                "disagg chaos: every served request has tokens")
    # the crashed worker's old session (its pool, its graphs) is gone
    # as soon as the new one replaced it
    fail_unless(first() is None, "disagg chaos: decode-0's old session, "
                                 "pool and graphs freed")
    torch.cuda.synchronize()
    mem_run = torch.cuda.memory_allocated()
    captures = {w.name: (w.captures, w.capture_s)
                for w in pool.decode_workers}
    pool_bytes = cont.pool_hbm_bytes(model.cfg, 8, serve.DISAGG_MAX_SEQ)[
        "total_bytes"]
    del pool, rep
    gc.collect()
    torch.cuda.empty_cache()
    mem_after = torch.cuda.memory_allocated()
    fail_unless(mem_after - mem0 < pool_bytes,
                f"disagg chaos: every pool freed once the fleet is gone "
                f"({mem0} -> {mem_after} B, a pool {pool_bytes} B)")
    emit(phase="disagg_chaos", requests=24, seconds=secs,
         n_served=s["n_served"], n_rejected=s["n_rejected"],
         n_retries=s["n_retries"], n_retransmits=s["n_retransmits"],
         n_failures=s["n_failures"], p95_latency_ms=s["p95_latency_ms"],
         captures=captures, pool_bytes=pool_bytes,
         memory_allocated_before=mem0,
         memory_allocated_end_of_run=mem_run,
         memory_allocated_after=mem_after)


DISAGG_LIVE_REQUESTS = 32


def phase_disagg_live(model) -> dict:
    """The fleet's live ``generate`` replica on the card: a live fleet of
    two generate replicas (``build_live_fleet``: each a
    ``DisaggEngineAdapter`` behind a ``Server`` over its own
    ``DisaggEngine`` at published width, 4 slots over 64 rows) under the
    fleet's energy-aware router, 32 ``prompt-burst`` requests of 16 new
    tokens: every rid answered once on the generate path, each request's
    tokens equal to a ``DisaggEngine``'s three-step API on the same
    inputs, one batch-1 flash prefill per request and layer and the
    decode kernel launched (the counters zeroed once the fleet is
    built, read after the run).  -> the attention kernels' launches."""
    from repro_torch.fleet import (FleetSimulator, build_live_fleet,
                                   make_generate_scenario)
    cfg, n = model.cfg, DISAGG_LIVE_REQUESTS
    pool = build_live_fleet(cfg, model, kinds=("generate", "generate"),
                            energy_model=serve.device_energy_model(
                                model.device), device="cuda")
    sc = make_generate_scenario("prompt-burst", n, qps=40.0, seed=1,
                                vocab=cfg.vocab, max_new=16)
    _zero_counters()
    t0 = time.perf_counter()
    rep = FleetSimulator(pool).run(sc.requests)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _attention_launches()
    rids = sorted(r.rid for r in rep.responses)
    fail_unless(rids == list(range(n)),
                "disagg live: every rid answered exactly once")
    fail_unless(all(r.path == "generate" for r in rep.responses),
                "disagg live: every request on the generate path")
    ref = DisaggEngine.build(cfg, model, n_slots=4,
                             max_seq=serve.DISAGG_MAX_SEQ, device="cuda")
    reqs = [cont.GenRequest(rid=r.rid, prompt=np.asarray(r.payload,
                                                         np.int32),
                            max_new=r.max_new) for r in sc.requests]
    _split(ref, reqs, None)
    got = {r.rid: list(r.output) for r in rep.responses}
    same = sum(got[r.rid] == r.generated for r in reqs)
    fail_unless(same == n, f"disagg live: {same} of {n} requests' tokens "
                           f"equal to the DisaggEngine's")
    fail_unless(launches["flash_attention"] == n * cfg.n_layers
                and launches["decode_attention"] > 0
                and launches["paged_decode_attention"] == 0,
                f"disagg live: one flash prefill per request and layer, "
                f"the decode kernel launched: {launches}")
    lat = np.array([r.t_finish - r.arrival_s for r in rep.responses])
    emit(phase="disagg_live", replicas=[r.name for r in pool.replicas],
         requests=n, seconds=secs, routed=rep.summary["routed"],
         tokens=sum(len(v) for v in got.values()),
         tokens_equal_disagg_engine=same,
         p50_latency_ms=float(np.percentile(lat, 50)) * 1e3,
         p95_latency_ms=float(np.percentile(lat, 95)) * 1e3,
         launches=launches)
    del pool, ref, rep
    torch.cuda.empty_cache()
    return launches


def phase_disagg(model, smi: str) -> dict:
    """The split-phase path on the card: parity (full width bf16, depth
    2 f32), insert-after-capture, the launcher's ``--fleet-disagg`` at
    published width on ``prompt-burst`` and ``long-decode`` (contiguous)
    and ``prompt-burst`` on a paged pool (bs 16), and the crash plus
    flap story.  -> the attention kernels' launches on the two paths."""
    t0 = time.perf_counter()
    phase_disagg_parity(model)
    phase_disagg_parity_f32()
    phase_disagg_chaos(model)
    live = phase_disagg_live(model)
    idle = nvidia_smi("power.draw")
    idle_w = float(idle.split()[0])
    runs = {
        "prompt_burst": _disagg_run("prompt_burst",
                                    ["--scenario", "prompt-burst"], idle_w),
        "long_decode": _disagg_run("long_decode",
                                   ["--scenario", "long-decode"], idle_w),
        "prompt_burst_paged": _disagg_run(
            "prompt_burst_paged", ["--scenario", "prompt-burst",
                                   "--kv-block-size", str(PAGED_BS)],
            idle_w),
    }
    emit(phase="disagg_summary", nvidia_smi=smi, idle_power_draw=idle,
         seconds=time.perf_counter() - t0)
    contiguous = {k: runs["prompt_burst"][k] + runs["long_decode"][k]
                  for k in runs["prompt_burst"]}
    return {"serve_disagg": contiguous,
            "serve_disagg_paged": runs["prompt_burst_paged"],
            "fleet_generate": live}


# ---------------------------------------------------------------------------
# sampling and the decode window as a CUDA graph
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
# |g_card - g_f64| <= GUMBEL_ULPS * eps * max(1, |g|), g_f64 the Gumbel
# float computed in float64 from the same bits and rounded to float32:
# the card's two float32 logs may round their last bits apart from it
# (tests/test_torch_sampling.py)
GUMBEL_ULPS = 2.0
GRAPH_REQUESTS, GRAPH_NEW = 16, 16       # two refill waves of 8 slots


def phase_sampling_keys(vocab: int):
    """On the card, at the window's shapes (8 slots, the vocabulary):
    ``step_keys`` and the Gumbel bits equal the port's numpy threefry bit
    for bit; the Gumbel floats within GUMBEL_ULPS of float64 from the same
    bits (the CPU's float32 distance to it printed beside, and a
    ``sampling_keys_cpu_fault`` line where the CPU is past the limit,
    which fails nothing: the card is what is checked); the sampled token
    beside the CPU's on the same bf16 logits (printed); and the cost of
    sampling one step by graph replay, part by part, beside the greedy
    argmax."""
    B, V = 8, vocab
    rng = np.random.default_rng(8)
    keys = np.stack([smp.request_key(0, rid) for rid in range(B)])
    pos = rng.integers(16, 128, B)
    kt = torch.tensor(keys.astype(np.int64), device="cuda")
    pt = torch.tensor(pos, device="cuda")
    sk = smp.step_keys(kt, pt)
    want = np.stack([smp.fold_in(keys[b], int(pos[b])) for b in range(B)])
    fail_unless(np.array_equal(sk.cpu().numpy(), want.astype(np.int64)),
                "sampling_keys: step_keys on the card == numpy threefry")
    bits = smp.random_bits(sk, (V,))
    k = want.astype(np.uint64)
    y0, y1 = smp.threefry2x32(k[:, :1], k[:, 1:], np.zeros((1, V), np.uint64),
                              np.arange(V, dtype=np.uint64)[None])
    fail_unless(np.array_equal(bits.cpu().numpy(), (y0 ^ y1).astype(np.int64)),
                "sampling_keys: Gumbel bits on the card == numpy threefry")
    # the yardstick: the uniform u from the same bits (exact f32
    # arithmetic, the same on any IEEE machine), then -log(-log(u)) in
    # float64, rounded to float32; the card and the CPU are each held to
    # it, the card's distance gating, the CPU's printed
    g = smp.gumbel_from_bits(bits).cpu().double()
    g_cpu = smp.gumbel_from_bits(bits.cpu()).double()
    bc = bits.cpu()
    f = ((bc >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp_min(f * (1.0 - tiny) + tiny, tiny).double()
    g64 = (-torch.log(-torch.log(u))).float().double()
    scale = torch.finfo(torch.float32).eps * g64.abs().clamp_min(1.0)
    eps = ((g - g64).abs() / scale).reshape(-1)
    eps_cpu = ((g_cpu - g64).abs() / scale).reshape(-1)
    ulps, worst = eps.max().item(), int(eps.argmax())
    cpu_ulps = eps_cpu.max().item()
    if cpu_ulps > GUMBEL_ULPS:          # the CPU's parts, for the record
        bad = (eps_cpu > GUMBEL_ULPS).nonzero()[:, 0]
        cw = int(eps_cpu.argmax())
        emit(phase="sampling_keys_cpu_fault", bad_first=int(bad[0]),
             bad_last=int(bad[-1]), bad=len(bad),
             bad_rows=torch.bincount(bad // V, minlength=B).tolist(),
             u=f.reshape(-1)[cw].item(),
             gumbel_cpu=g_cpu.reshape(-1)[cw].item(),
             gumbel_f64=g64.reshape(-1)[cw].item(),
             gumbel_card=g.reshape(-1)[cw].item(),
             cpu_max_eps_vs_f64=cpu_ulps,
             cpu=f"{torch.backends.cpu.get_cpu_capability()}, "
                 f"{torch.get_num_threads()} threads")
    fail_unless(ulps <= GUMBEL_ULPS,
                f"sampling_keys: Gumbel floats card vs float64 {ulps} eps "
                f"({int((eps > GUMBEL_ULPS).sum())} elements; the worst: "
                f"bits {int(bits.reshape(-1)[worst])}, card "
                f"{g.reshape(-1)[worst].item()!r}, float64 "
                f"{g64.reshape(-1)[worst].item()!r})")
    gen = torch.Generator(device="cuda").manual_seed(8)
    logits = (torch.randn(B, V, generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    temp = torch.full((B,), SAMPLED["temperature"], device="cuda")
    topk = torch.full((B,), SAMPLED["top_k"], dtype=torch.long, device="cuda")
    topp = torch.full((B,), SAMPLED["top_p"], device="cuda")
    tok = smp.sample_token(sk, logits, temp, topk, topp).cpu()
    tok_cpu = smp.sample_token(sk.cpu(), logits.cpu(), temp.cpu(), topk.cpu(),
                               topp.cpu())
    scaled = logits.float() / SAMPLED["temperature"]
    parts = {
        "step_keys": lambda: smp.step_keys(kt, pt),
        "gumbel": lambda: smp.gumbel(sk, (V,)),
        "sort": lambda: smp.descending_order(scaled),
        "masks": lambda: smp.top_p_mask(smp.top_k_mask(scaled, topk), topp),
        "sample_token": lambda: smp.sample_token(smp.step_keys(kt, pt),
                                                 logits, temp, topk, topp),
        "argmax": lambda: logits.argmax(-1),
    }
    ms = {name: graph_ms(fn, 20) for name, fn in parts.items()}
    emit(phase="sampling_keys", slots=B, vocab=V, step_keys_equal=True,
         gumbel_bits_equal=True, gumbel_max_eps_vs_f64=ulps,
         gumbel_eps_tol=GUMBEL_ULPS, cpu_gumbel_max_eps_vs_f64=cpu_ulps,
         sampled_tokens_equal_cpu=int((tok == tok_cpu).sum()),
         graph_ms=ms, sampling_over_argmax_ms=ms["sample_token"] - ms["argmax"],
         nvidia_smi=nvidia_smi("name,power.limit"))
    return ms


def _graph_requests(vocab: int, sampled: bool):
    rng = np.random.default_rng(9)
    sp = smp.SamplingParams(**SAMPLED) if sampled else None
    return [cont.GenRequest(rid=i, prompt=rng.integers(
        0, vocab, serve.GEN_PROMPT_LEN).astype(np.int32), max_new=GRAPH_NEW,
        sampling=sp) for i in range(GRAPH_REQUESTS)]


def _drive_windows(engine, reqs):
    """Every request queued at once in one session, advanced to the end;
    -> (tokens per request, each window's decode seconds and issue
    seconds from the host clock, the session)."""
    sess = engine.start_session(serve.GEN_PROMPT_LEN)
    for r in reqs:
        sess.push(r)
    dec, issue = [], []
    while not sess.idle:
        d0, p0, i0, h0 = (sess.device_s, sess.prefill_s, sess.issue_s,
                          sess.host_syncs)
        sess.advance()
        if sess.host_syncs > h0:
            dec.append(sess.device_s - d0 - (sess.prefill_s - p0))
            issue.append(sess.issue_s - i0)
    return [r.generated for r in reqs], dec, issue, sess


def phase_decode_graph(name: str, cfg, model) -> dict:
    """One engine at full width and 8 slots, 16 requests of 16 + 16
    tokens (two refill waves), greedy and sampled, uncaptured
    (``capture=False``) and captured: the captured tokens equal the
    uncaptured, one capture per kind, decode kernel launches (replays
    counted) equal layers x steps in both, and the steady windows (all
    but the first, which the captured run spends on its warm-up and
    capture) in ms per step, issue ms, and the card's busy share: one
    window's device time (its graph replayed) over the window's time."""
    out = {}
    # SSD and RG-LRU layers decode with no attention kernel, MLA layers
    # through the latent decode kernel
    attn_layers = sum(k in ("attn", "local_attn") for k in cfg.block_kinds)
    mla_layers = sum(k == "mla" for k in cfg.block_kinds)
    counter = (None if attn_layers == 0 else
               "paged_launches" if cfg.paged_kv else "launches")
    for mode in ("greedy", "sampled"):
        runs = {}
        for capture in (False, True):
            eng = cont.ContinuousBatchingEngine(
                cfg, model, n_slots=8, max_seq=serve.GEN_MAX_SEQ,
                device="cuda", capture=capture)
            da_mod.launches = da_mod.paged_launches = ld_mod.launches = 0
            toks, dec, issue, sess = _drive_windows(
                eng, _graph_requests(cfg.vocab, mode == "sampled"))
            torch.cuda.synchronize()
            steps = sess.host_syncs * eng.sync_every
            launches = getattr(da_mod, counter) if counter else None
            if counter:
                fail_unless(launches == attn_layers * steps,
                            f"decode_graph {name} {mode} capture={capture}: "
                            f"{launches} decode launches for "
                            f"{attn_layers} x {steps} layer-steps")
            fail_unless(ld_mod.launches == mla_layers * steps,
                        f"decode_graph {name} {mode} capture={capture}: "
                        f"{ld_mod.launches} latent decode launches for "
                        f"{mla_layers} x {steps} layer-steps")
            if mla_layers:
                launches = ld_mod.launches
            runs[capture] = dict(toks=toks, dec=dec, issue=issue, sess=sess,
                                 eng=eng, launches=launches)
        e, g = runs[False], runs[True]
        fail_unless(g["toks"] == e["toks"],
                    f"decode_graph {name} {mode}: captured tokens == "
                    f"uncaptured")
        other = "greedy" if mode == "sampled" else "sampled"
        fail_unless(g["eng"].decode_captures == {mode: 1, other: 0}
                    and e["eng"].decode_capture_count == 0,
                    f"decode_graph {name} {mode}: one capture of its kind: "
                    f"{g['eng'].decode_captures}")
        fail_unless(g["sess"].prefill_calls >= 2 and all(
            len(t) == GRAPH_NEW for t in g["toks"]),
            f"decode_graph {name} {mode}: two refill waves, 16 tokens each")
        graph = g["sess"]._graphs[mode].graph
        window_ms = _elapsed_ms(lambda: [graph.replay() for _ in range(5)]) / 5
        clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
        k = g["eng"].sync_every
        row = {}
        for label, r in (("uncaptured", e), ("captured", g)):
            wall = 1e3 * float(np.mean(r["dec"][1:]))
            row[label] = dict(
                ms_per_step=wall / k,
                window_ms=wall,
                window_issue_ms=1e3 * float(np.mean(r["issue"][1:])),
                card_busy_share=window_ms / wall,
                windows=len(r["dec"]),
                first_window_ms=1e3 * r["dec"][0],
                launches=r["launches"])
        row["window_device_ms"] = window_ms
        row["device_ms_per_step"] = window_ms / k
        emit(phase="decode_graph", engine=name, mode=mode,
             layers=cfg.n_layers, slots=8, sync_every=k,
             requests=GRAPH_REQUESTS, new_tokens=GRAPH_NEW,
             refill_waves=g["sess"].prefill_calls, tokens_equal=True,
             decode_capture_count=g["eng"].decode_capture_count,
             captures_by_kind=g["eng"].decode_captures, **row,
             sample=g["toks"][0][:8], clocks_power_temp=clocks,
             nvidia_smi=nvidia_smi("name,power.limit"))
        out[mode] = row
        del runs, e, g, graph
    return out


def phase_serve_generate_sampled():
    """The launcher with ``--temperature 0.8 --top-k 50 --top-p 0.95`` on
    stablelm-3b at published width: every request answered with tokens
    of the vocabulary, the window a graph captured once, both attention
    kernels launched."""
    args = serve.parser().parse_args(
        ["--device", "cuda", "--mode", "generate", "--arch", ARCH,
         "--requests", "32", "--new-tokens", "16", "--slots", "8",
         "--controller", "bio", "--temperature", "0.8", "--top-k", "50",
         "--top-p", "0.95"])
    fa_mod.launches = da_mod.launches = da_mod.paged_launches = 0
    t0 = time.perf_counter()
    summary, server = serve.serve_generate(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"flash_attention": fa_mod.launches,
                "decode_attention": da_mod.launches}
    vocab = get_config(ARCH).vocab
    resp = server.responses
    fail_unless(sorted(r.rid for r in resp) == list(range(args.requests)),
                "sampled: every request answered once")
    admitted = [r for r in resp if r.admitted]
    fail_unless(len(admitted) > 0 and all(
        isinstance(r.output, list) and 1 <= len(r.output) <= args.new_tokens
        and all(0 <= t < vocab for t in r.output) for r in admitted),
        "sampled: 1..16 token ids inside the vocabulary each")
    fail_unless(all(n > 0 for n in launches.values()),
                f"sampled: both attention kernels launched: {launches}")
    fail_unless(summary["window"] == "graph" and summary["captures"] == 1,
                f"sampled: the window one captured graph: {summary}")
    eng = server.engine.engine
    fail_unless(eng.default_sampling == smp.SamplingParams(**SAMPLED),
                "sampled: the engine's default sampling from the flags")
    steps_run = summary["host_syncs"] * eng.sync_every
    decode_s = summary["device_s"] - summary["prefill_s"]
    emit(phase="serve_generate_sampled", seconds=secs, launches=launches,
         admitted=len(admitted),
         tokens_per_busy_s=summary["tokens_generated"] / summary["busy_s"],
         decode_ms_per_step=decode_s / steps_run * 1e3,
         prefill_ms_per_call=(summary["prefill_s"]
                              / summary["prefill_calls"] * 1e3),
         **summary)


# ---------------------------------------------------------------------------
# self-speculative decode: the chunk entry, parity, the captured window
# ---------------------------------------------------------------------------

SPEC_DEPTH, SPEC_DRAFT_LAYERS = 3, 8

# the chunk entry's cases: (name, q/kv dtype, B, n, S, valid rows per slot
# including the chunk's own, or None for a chunk written by
# cache_write_chunk at start = S - 2 in half the slots: rows clamped onto
# S - 1)
SPEC_CHUNK_CASES = [
    # name, dtype, B, n, S, lengths (None: a clamped chunk), (H, K, hd)
    ("serving_bf16", torch.bfloat16, 8, 4, 128, list(range(17, 33, 2)),
     (32, 32, 80)),
    ("serving_f32", torch.float32, 8, 4, 128, list(range(17, 33, 2)),
     (32, 32, 80)),
    ("long_4096_bf16", torch.bfloat16, 8, 4, 4096,
     [4096 - 37 * b for b in range(8)], (32, 32, 80)),
    ("ragged_bf16", torch.bfloat16, 8, 4, 128, [4, 40, 77, 128, 9, 64, 100,
                                                33], (32, 32, 80)),
    ("clamped_bf16", torch.bfloat16, 8, 4, 128, None, (32, 32, 80)),
    # paligemma-3b's verify at D = 3: 8 query heads over 1 KV head of 256
    ("paligemma_bf16", torch.bfloat16, 8, 4, 128, list(range(17, 33, 2)),
     (8, 1, 256)),
    # granite's verify (the GQA body): 24 over 8 heads of 64, one span and
    # a 4096-row cache
    ("granite_bf16", torch.bfloat16, 8, 4, 128, list(range(17, 33, 2)),
     (24, 8, 64)),
    ("granite_long_4096_bf16", torch.bfloat16, 8, 4, 4096,
     [4096 - 37 * b for b in range(8)], (24, 8, 64)),
]


def _chunk_inputs(dt, B, n, S, lengths, gen, heads=(32, 32, 80)):
    """q [B,n,H,hd] and a BSHD cache [B,S,K,hd] read as [B,K,S,hd] views;
    kv_pos a valid prefix of ``lengths[b]`` rows and start = lengths - n,
    or (lengths None) a 100-row prefix and a chunk written into the cache
    by ``cache_write_chunk`` at start 120 (S - 8) and S - 2, whose last
    rows clamp onto row S - 1."""
    H, K, hd = heads
    q = torch.randn(B, n, H, hd, generator=gen, device="cuda").to(dt)
    kc, vc = (torch.randn(B, S, K, hd, generator=gen, device="cuda").to(dt)
              for _ in range(2))
    col = torch.arange(S, device="cuda")[None]
    if lengths is not None:
        n_ok = torch.as_tensor(lengths, device="cuda")[:, None]
        kv_pos = torch.where(col < n_ok, col, -1).to(torch.int32)
        start = (n_ok[:, 0] - n).to(torch.int32)
    else:
        kv_pos = torch.where(col < 100, col, -1).to(torch.int32).expand(
            B, S).contiguous()
        start = torch.tensor([S - 8, S - 2] * (B // 2), device="cuda")
        cache = attn_mod.KVCache(k=kc, v=vc, pos=kv_pos)
        kn, vn = (torch.randn(B, n, K, hd, generator=gen,
                              device="cuda").to(dt) for _ in range(2))
        attn_mod.cache_write_chunk(cache, kn, vn, start)
        torch.cuda.synchronize()
        fail_unless(bool((kv_pos[1::2, S - 1] == S - 2 + n - 1).all())
                    and torch.equal(kc[1::2, S - 1], kn[1::2, n - 1]),
                    "spec_chunk: the last chunk row wins the clamped row")
        start = start.to(torch.int32)
    return q, kc.transpose(1, 2), vc.transpose(1, 2), kv_pos, start


def chunk_bound_ms(q, k, kv_pos, start, peaks):
    """Least time of a chunk call: each slot's valid K/V rows (those of
    its last query row, which every other row's are a subset of) read
    once per kv head, q and out, kv_pos and start, over HBM bandwidth;
    or 4 * hd operations per visible (query, key) pair and head at the
    peak of the cache's type."""
    B, n, H, hd = q.shape
    K = k.shape[1]
    qpos = da_mod.chunk_positions(start, n)                       # [B, n]
    ok = (kv_pos[:, None] >= 0) & (kv_pos[:, None] <= qpos[..., None])
    pairs = int(ok.sum())
    rows = int(ok[:, -1].sum())
    nbytes = (2 * rows * K * hd * k.element_size()
              + 2 * q.numel() * q.element_size()
              + kv_pos.numel() * 4 + B * 4)
    rate = peaks["bf16" if k.dtype == torch.bfloat16 else "f32"]
    t_bytes, t_ops = nbytes / peaks["hbm"], 4 * hd * H * pairs / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", pairs, ok)


def phase_spec_chunk(peaks):
    """The chunk entry (``decode_attention_chunk_cuda``) against its plain
    version and, row by row, against the single-query decode kernel at
    ``start + j`` (``torch.equal``), timed beside its bound, n
    single-query launches and SDPA with the [B, H, n, S] mask; ->
    (the largest error, the serving row)."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    F = torch.nn.functional
    max_err, main = 0.0, None
    for name, dt, B, n, S, lengths, heads in SPEC_CHUNK_CASES:
        H, K, hd = heads
        q, k, v, kv_pos, start = _chunk_inputs(dt, B, n, S, lengths, gen,
                                               heads)
        kern = lambda: da_mod.decode_attention_chunk_cuda(  # noqa: E731
            q, k, v, kv_pos, start)
        plain = lambda: da_mod.decode_attention_chunk_plain(  # noqa: E731
            q, k, v, kv_pos, start)
        starts = [start + j for j in range(n)]
        singles = lambda: [da_mod.decode_attention_cuda(  # noqa: E731
            q[:, j], k, v, kv_pos, starts[j]) for j in range(n)]
        da_mod.chunk_launches = da_mod.combine_launches = 0
        got = kern()
        fail_unless(da_mod.chunk_launches == 1,
                    f"spec_chunk {name}: one launch counted per call")
        plan = da_mod.decode_span_plan(B * n, H, S, hd)
        fail_unless(da_mod.combine_launches == plan.combine,
                    f"spec_chunk {name}: {da_mod.combine_launches} span "
                    f"merges for {plan.spans} spans")
        want, rows = plain(), singles()
        torch.cuda.synchronize()
        bound_ms, bound_by, pairs, ok = chunk_bound_ms(q, k, kv_pos, start,
                                                       peaks)
        fail_unless(bool(ok.any(-1).all()),
                    f"spec_chunk {name}: every query row has a valid key")
        fail_unless(bool(torch.isfinite(got.float()).all()),
                    f"spec_chunk {name}: non-finite output")
        equal = [bool(torch.equal(got[:, j], rows[j])) for j in range(n)]
        fail_unless(all(equal), f"spec_chunk {name}: row j == the single "
                                f"query at start + j: {equal}")
        err = (got.float() - want.float()).abs().max().item()
        row_err = row_scaled_error(got, want)
        f32 = dt == torch.float32
        tol = F32_TOL if f32 else BF16_TOL
        fail_unless(err <= tol, f"spec_chunk {name}: kernel vs plain max abs "
                                f"err {err} > {tol}")
        fail_unless(f32 or row_err <= ATTN_BF16_ROW_TOL,
                    f"spec_chunk {name}: row-scaled err {row_err} > "
                    f"{ATTN_BF16_ROW_TOL}")
        mask = ok[:, None]                                   # [B,1,n,S]
        qh = q.transpose(1, 2)                               # [B,H,n,hd]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, k, v, attn_mask=mask, enable_gqa=H != K)
        lib_err = (lib().transpose(1, 2).float() - want.float()).abs().max(
        ).item()
        it = 20 if S > 1024 else 200
        row = dict(phase="spec_chunk", kernel="decode_attention_chunk",
                   case=name, B=B, n=n, H=H, K=K, S=S, hd=hd,
                   dtype=str(dt).replace("torch.", ""),
                   valid_pairs=pairs, spans=plan.spans,
                   combine_launches=int(plan.combine),
                   rows_equal_single_query=True, max_abs_err=err, tol=tol,
                   row_scaled_err=row_err,
                   row_tol=None if f32 else ATTN_BF16_ROW_TOL,
                   ms=graph_ms(kern, it), call_ms=time_ms(kern, it),
                   plain_ms=graph_ms(plain, max(it // 10, 2)),
                   single_query_launches_ms=graph_ms(singles, it),
                   library_ms=graph_ms(lib, it),
                   library_computes="scaled_dot_product_attention, "
                                    "[B, H, n, S] mask",
                   library_max_abs_err=lib_err,
                   bound_ms=bound_ms, bound_by=bound_by)
        row["share_of_bound"] = bound_ms / row["ms"]
        if name in EARLIER:
            row["earlier"] = EARLIER[name]
        emit(**row)
        max_err = max(max_err, err)
        if name == "serving_bf16":
            main = row
    return max_err, main


def _aligned_copy(model, from_layer: int):
    """A copy of ``model`` whose layers ``from_layer`` .. are the identity
    on the residual stream (their attention and MLP output projections
    zeroed), so a draft of the first ``from_layer`` layers agrees with
    the full model up to the two passes' rounding."""
    m = copy.deepcopy(model)
    with torch.no_grad():
        for layer in m.layers[from_layer:]:
            layer.mix.wo.zero_()
            if layer.mix.has_bias:
                layer.mix.bo.zero_()
            layer.mlp.w_down.zero_()
            if hasattr(layer.mlp, "b_down"):
                layer.mlp.b_down.zero_()
    return m


def _spec_greedy(model, prompts, n_new, depth, draft_layers):
    """Lockstep greedy speculative decode, the engine's macro-step without
    its retire masks (every row decodes ``n_new`` tokens): per step, the
    draft's ``depth`` tokens, one verify chunk, the accepted prefix and
    the full model's next token.  -> (tokens [B, n_new], the verify
    logits each token was chosen from [B, n_new, V]), on the CPU."""
    B, S = prompts.shape
    cache = tfm.init_cache(model.cfg, B, S + n_new + depth + 1,
                           device=model.device)
    draft = model.draft_prefix(draft_layers)
    logits, cache = model.prefill(prompts, cache)
    toks = [[int(t)] for t in logits[:, -1].argmax(-1).cpu()]
    seen = [[row] for row in logits[:, -1].float().cpu()]
    pos = torch.full((B,), S, dtype=torch.long, device=model.device)
    while min(len(t) for t in toks) < n_new:
        tok = torch.tensor([t[-1] for t in toks],
                           device=model.device)[:, None]
        dtok, dpos, drafts = tok, pos, []
        for _ in range(depth):
            lg, _ = draft.decode_step(dtok, cache, dpos)
            dtok, dpos = lg[:, 0].argmax(-1)[:, None], dpos + 1
            drafts.append(dtok)
        lg, _ = model.decode_chunk(torch.cat([tok, *drafts], 1), cache, pos)
        full = lg.argmax(-1).cpu()
        dr = torch.cat(drafts, 1).cpu()
        lgc = lg.float().cpu()
        adv = []
        for b in range(B):
            a = 0
            while a < depth and dr[b, a] == full[b, a]:
                a += 1
            for j in range(a + 1):
                toks[b].append(int(full[b, j]))
                seen[b].append(lgc[b, j])
            adv.append(a + 1)
        pos = pos + torch.tensor(adv, device=model.device)
    return (torch.tensor([t[:n_new] for t in toks]),
            torch.stack([torch.stack(s[:n_new]) for s in seen]))


def _chunk_vs_step(model, prompts, n=SPEC_DEPTH + 1):
    """The verify chunk's logits against ``n`` sequential decode steps at
    the same positions after the same prefill, fed the steps' greedy
    tokens: the largest difference over the largest |logit|."""
    B, S = prompts.shape
    caches = [tfm.init_cache(model.cfg, B, S + n, device=model.device)
              for _ in range(2)]
    logits = [model.prefill(prompts, c)[0] for c in caches][0]
    tok, toks, steps = logits[:, -1].argmax(-1)[:, None], [], []
    for j in range(n):
        toks.append(tok)
        lg, _ = model.decode_step(tok, caches[1], S + j)
        steps.append(lg)
        tok = lg[:, -1].argmax(-1)[:, None]
    chunk, _ = model.decode_chunk(torch.cat(toks, 1), caches[0], S)
    step = torch.cat(steps, 1).float()
    return ((chunk.float() - step).abs().max().item()
            / step.abs().max().item())


def phase_parity_spec(lm):
    """Speculative against non-speculative tokens on the card.  Published
    width at depth 2 in f32 with f32 caches (TF32 off, PyTorch's default,
    printed), D = 3 over a one-layer draft, greedy and sampled, aligned
    (layer 1 the identity) and seeded weights, 16 requests of 16 + 16
    tokens through the captured engines: the same tokens for every
    request.  The verify chunk's logits against sequential steps at both
    depths.  At full depth in bf16 (the served model, draft of 8 layers),
    lockstep greedy: the token agreement, and every first divergence a
    near-tie (its top-2 gap at most twice the two paths' logit difference
    there), printed."""
    cfg = get_config(ARCH)
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    fail_unless(not tf32, "parity_spec: TF32 off for the f32 products")
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    seeded = tfm.init_lm(cfg2, 0, device="cuda")
    models = {"seeded": seeded, "aligned": _aligned_copy(seeded, 1)}
    init_cache = tfm.init_cache
    tfm.init_cache = functools.partial(init_cache, dtype=torch.float32)
    results = {}
    try:
        for wname, m in models.items():
            for mode in ("greedy", "sampled"):
                runs = {}
                for depth in (SPEC_DEPTH, 0):
                    eng = cont.ContinuousBatchingEngine(
                        cfg2.replace(draft_layers=1 if depth else 0), m,
                        n_slots=8, max_seq=serve.GEN_MAX_SEQ, device="cuda",
                        draft_depth=depth)
                    reqs = _graph_requests(cfg.vocab, mode == "sampled")
                    st = eng.serve(reqs, prompt_len=serve.GEN_PROMPT_LEN)
                    runs[depth] = ([r.generated for r in reqs], st)
                (spec, st), (plain, _) = runs[SPEC_DEPTH], runs[0]
                same = [a == b for a, b in zip(spec, plain)]
                fail_unless(all(same), f"parity_spec depth-2 f32 {wname} "
                                       f"{mode}: spec tokens == non-spec, "
                                       f"per request: {same}")
                results[f"{wname}_{mode}"] = dict(
                    requests_equal=sum(same), acceptance_rate=st[
                        "acceptance_rate"],
                    accepted_per_step=st["accepted_per_step"],
                    captures=st["captures"])
        prompts = np.random.default_rng(11).integers(0, cfg.vocab, (8, 16))
        d2_chunk = _chunk_vs_step(seeded, prompts)
    finally:
        tfm.init_cache = init_cache
    del models, seeded
    full_chunk = _chunk_vs_step(lm, prompts)
    spec, s_logits = _spec_greedy(lm, prompts, 16, SPEC_DEPTH,
                                  SPEC_DRAFT_LAYERS)
    _, plain, p_logits = _greedy_lockstep(lm, prompts, 16,
                                          dtype=torch.bfloat16)
    divergences = []
    for r in range(spec.shape[0]):
        differ = (spec[r] != plain[r]).nonzero()
        if len(differ) == 0:
            continue
        i = int(differ[0])
        top2 = p_logits[r, i].topk(2).values
        gap = (top2[0] - top2[1]).item()
        step_err = (s_logits[r, i] - p_logits[r, i]).abs().max().item()
        divergences.append(dict(row=r, step=i, top2_gap=gap,
                                verify_vs_step_logit_err=step_err,
                                near_tie=gap <= 2 * step_err))
    fail_unless(all(d["near_tie"] for d in divergences),
                f"parity_spec full-depth bf16: a divergence that is not a "
                f"near-tie: {divergences}")
    emit(phase="parity_spec", tf32=tf32, depth=SPEC_DEPTH,
         depth2_f32=results,
         depth2_f32_chunk_vs_step_logit_err_over_max=d2_chunk,
         full_bf16_chunk_vs_step_logit_err_over_max=full_chunk,
         full_bf16_draft_layers=SPEC_DRAFT_LAYERS,
         full_bf16_greedy_token_agreement=float(
             (spec == plain).float().mean()),
         full_bf16_divergences=divergences,
         nvidia_smi=nvidia_smi("name,power.limit"))


def _drive_spec_windows(engine, reqs):
    """``_drive_windows`` for a speculative or plain session: -> (tokens
    per request, per window: decode seconds, issue seconds, tokens
    emitted, slot-steps live and the live depth; the session)."""
    sess = engine.start_session(serve.GEN_PROMPT_LEN)
    for r in reqs:
        sess.push(r)
    wins = []
    while not sess.idle:
        d0, p0, i0, h0 = (sess.device_s, sess.prefill_s, sess.issue_s,
                          sess.host_syncs)
        o0, a0 = sess.occupied_slot_steps, sess.spec_accepted
        sess.advance()
        if sess.host_syncs > h0:
            slot_steps = sess.occupied_slot_steps - o0
            wins.append(dict(
                dec=sess.device_s - d0 - (sess.prefill_s - p0),
                issue=sess.issue_s - i0,
                tokens=slot_steps + sess.spec_accepted - a0,
                slot_steps=slot_steps, depth=sess.last_depth))
    return [r.generated for r in reqs], wins, sess


def phase_decode_graph_spec(lm):
    """The speculative window at full width: 8 slots, a draft of the
    first 8 layers, D = 3, 16 requests of 16 + 16 tokens (two refill
    waves), with aligned weights (layers 8-31 the identity) and the
    served model's seeded ones, greedy and sampled, uncaptured and
    captured: the same tokens, one capture per session and kind (in the
    aligned greedy session while the live depth moves), decode launches
    = D x 8 x macro-steps and chunk launches = 32 x macro-steps with
    replays counted; ms per emitted token and per macro-step, the card's
    busy share, acceptance, tokens per macro-step, the modelled energy
    per token, and the non-speculative captured ms per step on the same
    weights."""
    cfg = lm.cfg
    spec_cfg = cfg.replace(draft_layers=SPEC_DRAFT_LAYERS)
    weights = {"aligned": _aligned_copy(lm, SPEC_DRAFT_LAYERS), "seeded": lm}
    out = {}
    for wname, model in weights.items():
        # the non-speculative captured step on the same weights
        eng = cont.ContinuousBatchingEngine(cfg, model, n_slots=8,
                                            max_seq=serve.GEN_MAX_SEQ,
                                            device="cuda")
        plain_toks, pw, _ = _drive_spec_windows(
            eng, _graph_requests(cfg.vocab, False))
        plain_ms = 1e3 * float(np.mean([w["dec"] for w in pw[1:]])) / (
            eng.sync_every)
        for mode in ("greedy", "sampled"):
            runs = {}
            for capture in (False, True):
                eng = cont.ContinuousBatchingEngine(
                    spec_cfg, model, n_slots=8, max_seq=serve.GEN_MAX_SEQ,
                    device="cuda", capture=capture, draft_depth=SPEC_DEPTH)
                da_mod.launches = da_mod.chunk_launches = 0
                toks, wins, sess = _drive_spec_windows(
                    eng, _graph_requests(cfg.vocab, mode == "sampled"))
                torch.cuda.synchronize()
                macro = sess.host_syncs * eng.sync_every
                launches = (da_mod.launches, da_mod.chunk_launches)
                want = (SPEC_DEPTH * SPEC_DRAFT_LAYERS * macro,
                        cfg.n_layers * macro)
                fail_unless(launches == want,
                            f"decode_graph_spec {wname} {mode} capture="
                            f"{capture}: launches {launches} for {macro} "
                            f"macro-steps")
                runs[capture] = dict(toks=toks, wins=wins, sess=sess,
                                     eng=eng, launches=launches)
            e, g = runs[False], runs[True]
            fail_unless(g["toks"] == e["toks"],
                        f"decode_graph_spec {wname} {mode}: captured tokens "
                        f"== uncaptured")
            other = "greedy" if mode == "sampled" else "sampled"
            fail_unless(g["eng"].decode_captures == {mode: 1, other: 0}
                        and e["eng"].decode_capture_count == 0,
                        f"decode_graph_spec {wname} {mode}: one capture of "
                        f"its kind: {g['eng'].decode_captures}")
            depths = [w["depth"] for w in g["wins"]]
            if wname == "aligned" and mode == "greedy":
                fail_unless(len(set(depths)) >= 2,
                            f"decode_graph_spec aligned: the live depth "
                            f"moved: {depths}")
            if mode == "greedy":
                agree = sum(a == b for a, b in zip(g["toks"], plain_toks))
            graph = g["sess"]._graphs[mode].graph
            window_ms = _elapsed_ms(
                lambda: [graph.replay() for _ in range(5)]) / 5
            st = g["sess"].stats()
            k = g["eng"].sync_every
            steady = g["wins"][1:]
            wall = 1e3 * float(np.mean([w["dec"] for w in steady]))
            per_slot = (sum(w["tokens"] for w in steady)
                        / max(sum(w["slot_steps"] for w in steady), 1))
            row = dict(
                ms_per_macro_step=wall / k,
                tokens_per_live_slot_macro_step=per_slot,
                ms_per_token=wall / k / per_slot,
                ms_per_token_over_nonspec_step=wall / k / per_slot / plain_ms,
                device_ms_per_macro_step=window_ms / k,
                device_ms_per_token=window_ms / k / per_slot,
                window_ms=wall, window_device_ms=window_ms,
                window_issue_ms=1e3 * float(np.mean(
                    [w["issue"] for w in steady])),
                card_busy_share=window_ms / wall,
                uncaptured_ms_per_macro_step=1e3 * float(np.mean(
                    [w["dec"] for w in e["wins"][1:]])) / k,
                first_window_ms=1e3 * g["wins"][0]["dec"],
                windows=len(g["wins"]), macro_steps=g["sess"].host_syncs * k,
                live_macro_steps=st["decode_steps"],
                acceptance_rate=st["acceptance_rate"],
                accepted_per_step=st["accepted_per_step"],
                energy_per_token_model=st["energy_per_token_model"],
                live_depths=depths,
                launches=dict(decode=g["launches"][0],
                              chunk=g["launches"][1]),
                nonspec_captured_ms_per_step=plain_ms)
            if mode == "greedy":
                row["requests_equal_to_nonspec"] = agree
            emit(phase="decode_graph_spec", weights=wname, mode=mode,
                 layers=cfg.n_layers, draft_layers=SPEC_DRAFT_LAYERS,
                 depth=SPEC_DEPTH, slots=8, sync_every=k,
                 requests=GRAPH_REQUESTS, new_tokens=GRAPH_NEW,
                 refill_waves=g["sess"].prefill_calls, tokens_equal=True,
                 captures_by_kind=g["eng"].decode_captures, **row,
                 clocks_power_temp=nvidia_smi(
                     "clocks.sm,power.draw,temperature.gpu"),
                 nvidia_smi=nvidia_smi("name,power.limit"))
            out[f"{wname}_{mode}"] = row
            del runs, e, g, graph
    del weights
    torch.cuda.empty_cache()
    return out


def phase_serve_generate_spec():
    """The launcher with ``--draft-depth 3 --draft-layers 8`` on
    stablelm-3b at published width: every request answered, the flash,
    decode and chunk kernels launched (counters zeroed just before, read
    just after), the window one captured graph; -> the launch counts."""
    args = serve.parser().parse_args(
        ["--device", "cuda", "--mode", "generate", "--arch", ARCH,
         "--requests", "32", "--new-tokens", "16", "--slots", "8",
         "--controller", "bio", "--draft-depth", str(SPEC_DEPTH),
         "--draft-layers", str(SPEC_DRAFT_LAYERS)])
    fa_mod.launches = 0
    da_mod.launches = da_mod.paged_launches = da_mod.chunk_launches = 0
    t0 = time.perf_counter()
    summary, server = serve.serve_generate(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"flash_attention": fa_mod.launches,
                "decode_attention": da_mod.launches,
                "decode_attention_chunk": da_mod.chunk_launches}
    fail_unless(da_mod.paged_launches == 0,
                "spec: the contiguous pool runs no paged kernel")
    vocab = get_config(ARCH).vocab
    resp = server.responses
    fail_unless(sorted(r.rid for r in resp) == list(range(args.requests)),
                "spec: every request answered once")
    admitted = [r for r in resp if r.admitted]
    fail_unless(len(admitted) > 0 and all(
        isinstance(r.output, list) and 1 <= len(r.output) <= args.new_tokens
        and all(0 <= t < vocab for t in r.output) for r in admitted),
        "spec: 1..16 token ids inside the vocabulary each")
    fail_unless(all(n > 0 for n in launches.values()),
                f"spec: flash, decode and chunk kernels launched: {launches}")
    fail_unless(summary["window"] == "graph" and summary["captures"] == 1
                and summary["mode"] == "spec",
                f"spec: the window one captured graph: {summary}")
    eng = server.engine.engine
    fail_unless(eng.draft_depth == SPEC_DEPTH
                and eng.cfg.draft_layers == SPEC_DRAFT_LAYERS
                and eng.params.cfg.n_layers == 32,
                "spec: published width, D = 3 over 8 draft layers")
    macro = summary["host_syncs"] * eng.sync_every
    decode_s = summary["device_s"] - summary["prefill_s"]
    emit(phase="serve_generate_spec", seconds=secs, launches=launches,
         admitted=len(admitted),
         tokens_per_busy_s=summary["tokens_generated"] / summary["busy_s"],
         decode_ms_per_macro_step=decode_s / macro * 1e3,
         prefill_ms_per_call=(summary["prefill_s"]
                              / summary["prefill_calls"] * 1e3),
         **summary)
    return launches


# ---------------------------------------------------------------------------
# the SSD (mamba2) generate path: scan kernel, serve, parity, breakdown
# ---------------------------------------------------------------------------

def _ssd_inputs(case, gen):
    """The scan's inputs as the model makes them: x, Bm and Cm views into
    one [B, S, H*hd + 2N] conv output (the kernel reads their strides), dt
    softplus'd, A mamba2's decay rates -(1..16); h0 zero (a fresh decode
    cache) or random."""
    B, S, H, hd, N, dt_ = (case[k] for k in ("B", "S", "H", "hd", "N",
                                             "dtype"))
    xbc = torch.randn(B, S, H * hd + 2 * N, generator=gen,
                      device="cuda").to(dt_)
    x = xbc[..., :H * hd].reshape(B, S, H, hd)
    Bm, Cm = xbc[..., H * hd:H * hd + N], xbc[..., H * hd + N:]
    dt = torch.nn.functional.softplus(torch.randn(
        B, S, H, generator=gen, device="cuda")).to(dt_)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    h0 = (torch.randn(B, H, hd, N, generator=gen, device="cuda")
          if case["h0"] == "random" else
          torch.zeros(B, H, hd, N, device="cuda"))
    return x, dt, A, Bm, Cm, h0


def ssd_bound_ms(case, peaks):
    """Least time for the work, as a dict.  ``bound_ms``: x, dt, Bm, Cm
    (and h0) read once, y (and h_last) written once over HBM bandwidth,
    or the chunked algorithm's operations at the kernel's chunk Q
    (``ssd_plan``) over the peak of the inputs' type (f32: the CUDA
    cores, whatever units the kernel uses, so that the share compares
    across designs): per (b, chunk of q rows) 2 q^2 N for C.B^T, and
    per head q (q + 1) hd for the causal att.x, 2 q hd N for
    the state update and 2 q hd N for the inter-chunk term (not on the
    first chunk of the zero-state entry); whichever is larger.  Where
    the kernel runs those products on the tensor cores (the
    chunk-parallel schedule), ``tc_bound_ms`` is the same bytes against
    the arithmetic it really runs: 3xTF32, three TF32 products for each,
    at the TF32 dense peak; else None."""
    B, S, H, hd, N = (case[k] for k in ("B", "S", "H", "hd", "N"))
    item = case["dtype"].itemsize
    nbytes = (2 * B * S * H * hd + B * S * H + 2 * B * S * N) * item + 4 * H
    state = case["entry"] == "chunked"
    if state:
        nbytes += 2 * 4 * B * H * hd * N
    plan = ssd_mod.ssd_plan(S)
    Q = plan["chunk"]
    ops_ = 0
    for c in range(-(-S // Q)):
        q = min(Q, S - c * Q)
        inter = 2 * q * hd * N if (state or c > 0) else 0
        ops_ += 2 * q * q * N + H * (q * (q + 1) * hd + 2 * q * hd * N
                                     + inter)
    ops_ *= B
    rate = peaks["bf16" if case["dtype"] == torch.bfloat16 else "f32"]
    t_bytes, t_ops = nbytes / peaks["hbm"], ops_ / rate
    out = dict(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               chunk=Q, tc_bound_ms=None, tc_bound_by=None)
    if plan["schedule"] == "chunk_parallel":
        t_tc = 3 * ops_ / peaks["tf32"]
        out.update(tc_bound_ms=max(t_bytes, t_tc) * 1e3,
                   tc_bound_by="bytes" if t_bytes >= t_tc else "operations")
    return out


SSD_CASES = [
    # the serving prefill: up to 8 prompts of 16 tokens, mamba2's 48 heads
    # of 64 and state 128, into a fresh (zero) decode cache
    dict(name="prefill_main", entry="chunked", B=8, S=16, h0="zero",
         dtype=torch.float32, iters=200),
    dict(name="scan_main", entry="scan", B=8, S=16, h0="zero",
         dtype=torch.float32, iters=200),
    dict(name="prefill_main_state", entry="chunked", B=8, S=16, h0="random",
         dtype=torch.float32, iters=200),
    dict(name="scan_main_bf16", entry="scan", B=8, S=16, h0="zero",
         dtype=torch.bfloat16, iters=200),
    # 16 of the reference's 256-token chunks, 64 of the kernel's
    dict(name="scan_long", entry="scan", B=1, S=4096, h0="zero",
         dtype=torch.float32, iters=10),
    dict(name="chunked_long_state", entry="chunked", B=1, S=4096,
         h0="random", dtype=torch.float32, iters=10),
    dict(name="chunked_long_bf16", entry="chunked", B=1, S=4096, h0="zero",
         dtype=torch.bfloat16, iters=10),
    # a ragged tail: 1000 = 15 x 64 + 40
    dict(name="scan_ragged", entry="scan", B=2, S=1000, h0="zero",
         dtype=torch.float32, iters=20),
    dict(name="chunked_ragged_state_bf16", entry="chunked", B=2, S=1000,
         h0="random", dtype=torch.bfloat16, iters=20),
    # the parity prompt of parity_generate_ssm: 300 = 4 x 64 + 44
    dict(name="prefill_parity", entry="chunked", B=2, S=300, h0="random",
         dtype=torch.float32, iters=50),
    # one row past one chunk
    dict(name="chunk_edge", entry="scan", B=1, S=65, h0="zero",
         dtype=torch.bfloat16, iters=100),
]


def phase_ssd(peaks):
    """The SSD scan kernel on the card against its plain versions, both
    entry points; -> {"max_err", "main"}.  Tolerances are relative to
    the plain output's largest magnitude: f32 to 1e-4 and bf16 to 3e-2,
    since the kernel sums over N and over a chunk's rows in another order
    and with another chunk length than the plain versions (bf16: the
    output is rounded to bf16 on both sides, one ulp is 4e-3)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    cfg = get_config(SSM_ARCH)
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    out = {"max_err": 0.0, "max_rel_err": 0.0, "main": None}
    for case in SSD_CASES:
        case = dict(case, H=H, hd=cfg.ssm_headdim, N=cfg.ssm_state)
        x, dt, A, Bm, Cm, h0 = _ssd_inputs(case, gen)
        if case["entry"] == "scan":
            kern = lambda: ssd_mod.ssd_scan_cuda(  # noqa: E731
                x, dt, A, Bm, Cm)
            plain = lambda: ssd_mod.ssd_scan_plain(  # noqa: E731
                x, dt, A, Bm, Cm)
            got, want = kern(), plain()
            h_err = None
        else:
            kern = lambda: ssd_mod.ssd_chunked_cuda(  # noqa: E731
                x, dt, A, Bm, Cm, h0)
            plain = lambda: ssd_mod.ssd_chunked_plain(  # noqa: E731
                x, dt, A, Bm, Cm, h0, cfg.ssm_chunk)
            (got, h_got), (want, h_want) = kern(), plain()
        torch.cuda.synchronize()
        tol = F32_TOL if case["dtype"] == torch.float32 else BF16_TOL
        fail_unless(bool(torch.isfinite(got.float()).all())
                    and got.dtype == x.dtype and got.shape == x.shape,
                    f"ssd {case['name']}: finite y of x's shape and dtype")
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        fail_unless(err <= tol * scale, f"ssd {case['name']}: kernel vs "
                                        f"plain {err} > {tol} x {scale}")
        if case["entry"] == "chunked":
            h_scale = h_want.abs().max().item()
            h_err = (h_got - h_want).abs().max().item()
            fail_unless(bool(torch.isfinite(h_got).all())
                        and h_err <= F32_TOL * h_scale,
                        f"ssd {case['name']}: h_last {h_err} > "
                        f"{F32_TOL} x {h_scale}")
        it = case["iters"]
        # the per-token plain version over thousands of tokens is a loop of
        # tens of thousands of launches: timed from Python, once
        short = case["S"] <= 64 or case["entry"] == "chunked"
        bound = ssd_bound_ms(case, peaks)
        plan = ssd_mod.ssd_plan(case["S"])
        row = dict(phase="ssd", kernel="ssd_scan", case=case["name"],
                   entry=case["entry"], B=case["B"], S=case["S"], H=H,
                   hd=case["hd"], N=case["N"], h0=case["h0"],
                   dtype=str(case["dtype"]).replace("torch.", ""),
                   schedule=plan["schedule"],
                   kernels_per_call=plan["kernels"],
                   kernel_chunk=plan["chunk"], max_abs_err=err,
                   max_rel_err=err / scale,
                   tol=tol, h_last_max_abs_err=h_err,
                   ms=graph_ms(kern, it), call_ms=time_ms(kern, it),
                   plain_ms=(graph_ms(plain, max(it // 4, 2)) if short
                             else time_ms(plain, 1)),
                   plain_timing="graph replay" if short else "one call",
                   library_ms=None,
                   library_computes="none: no one PyTorch call computes "
                                    "the SSD scan",
                   bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                   bound_chunk=f"operations counted at the kernel's chunk "
                               f"of {plan['chunk']} rows",
                   tc_bound_ms=bound["tc_bound_ms"],
                   tc_bound_by=bound["tc_bound_by"])
        row["share_of_bound"] = bound["bound_ms"] / row["ms"]
        row["share_of_tc_bound"] = (None if bound["tc_bound_ms"] is None
                                    else bound["tc_bound_ms"] / row["ms"])
        emit(**row)
        out["max_err"] = max(out["max_err"], err)
        out["max_rel_err"] = max(out["max_rel_err"], err / scale)
        if case["name"] == "prefill_main":
            out["main"] = row
    return out


def phase_serve_generate_ssm():
    """mamba2-780m at published width through the launcher; -> (the SSD
    kernel's launches over the run, the served model)."""
    args = serve.parser().parse_args(
        ["--device", "cuda", "--mode", "generate", "--arch", SSM_ARCH,
         "--requests", "32", "--new-tokens", "16", "--slots", "8",
         "--controller", "bio"])
    ssd_mod.launches = fa_mod.launches = 0
    da_mod.launches = da_mod.paged_launches = 0
    t0 = time.perf_counter()
    summary, server = serve.serve_generate(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ssd_mod.launches
    attention = {"flash_attention": fa_mod.launches,
                 "decode_attention": da_mod.launches,
                 "paged_decode_attention": da_mod.paged_launches}
    cfg = get_config(SSM_ARCH)
    resp = server.responses
    fail_unless(sorted(r.rid for r in resp) == list(range(args.requests)),
                "ssm: every request answered once")
    admitted = [r for r in resp if r.admitted]
    fail_unless(len(admitted) > 0 and all(
        isinstance(r.output, list) and 1 <= len(r.output) <= args.new_tokens
        and all(0 <= t < cfg.vocab for t in r.output) for r in admitted),
        "ssm: 1..16 token ids inside the vocabulary each")
    fail_unless(launches > 0, "ssm: the SSD scan kernel launched")
    fail_unless(not any(attention.values()),
                f"ssm: no attention kernel on an SSD stack: {attention}")
    fail_unless(summary["window"] == "graph" and summary["captures"] == 1,
                f"ssm: the window one captured graph: {summary}")
    model = server.engine.engine.params
    fail_unless(model.cfg.n_layers == 48 and model.cfg.d_model == 1536
                and model.emb.dtype == torch.bfloat16,
                "ssm: published width, 48 layers, bf16")
    fail_unless(summary["kv_pool_bytes"] == 619_315_204,
                f"ssm: pool bytes {summary['kv_pool_bytes']}")
    steps_run = summary["host_syncs"] * server.engine.engine.sync_every
    decode_s = summary["device_s"] - summary["prefill_s"]
    emit(phase="serve_generate_ssm", seconds=secs, launches=launches,
         attention_launches=attention, admitted=len(admitted),
         parameters=sum(p.numel() for p in model.parameters()),
         weight_bytes=sum(p.numel() * p.element_size()
                          for p in model.parameters()),
         tokens_per_busy_s=summary["tokens_generated"] / summary["busy_s"],
         decode_ms_per_step=decode_s / steps_run * 1e3,
         prefill_ms_per_call=(summary["prefill_s"]
                              / summary["prefill_calls"] * 1e3),
         **summary)
    return launches, model


def _full_depth_f32_gate(cfg, prompts, n_new=16):
    """mamba2 at published width and full depth (48 layers) in f32 with
    an f32 cache, on the card: the kernel path (``attn_impl="auto"``)
    against the model's own chunked path (``"xla"``: ``ssd_chunked_plain``
    in cuBLAS f32), the same seeded weights and prompts.  Gates: the
    prefill logits within FULL_F32_LOGITS_TOL of the reference's largest
    |logit|, the first greedy token of every row equal, and each row's
    first divergence a near-tie: the reference's top-2 logit gap at that
    step at most twice the largest logit error there (each of the two
    logits may move by that error, so a flip needs a gap below twice
    it); a divergence at a wider gap is a kernel fault.  After a row's
    first divergence the two paths decode different prefixes, so only
    that one is judged; the agreement over all ``n_new`` tokens is
    printed."""
    m = tfm.init_lm(cfg.replace(dtype="float32"), 0, device="cuda")
    fail_unless(m.cfg.n_layers == 48 and m.emb.dtype == torch.float32,
                "ssm f32 gate: 48 layers in f32")
    res = {}
    for impl in ("auto", "xla"):
        m.attn_impl = impl
        ssd_mod.launches = 0
        res[impl] = _greedy_lockstep(m, prompts, n_new)
        fail_unless((ssd_mod.launches > 0) == (impl == "auto"),
                    f"ssm f32 gate: {impl} ran the SSD kernel "
                    f"{ssd_mod.launches} times")
    del m
    (la, ta, sa), (lx, tx, sx) = res["auto"], res["xla"]
    scale = lx.abs().max().item()
    err = (la - lx).abs().max().item()
    fail_unless(bool(torch.isfinite(la).all())
                and err <= FULL_F32_LOGITS_TOL * scale,
                f"ssm full-depth f32 prefill logits kernel vs xla: {err} > "
                f"{FULL_F32_LOGITS_TOL} x {scale}")
    fail_unless(torch.equal(ta[:, 0], tx[:, 0]),
                "ssm full-depth f32: first greedy tokens equal")
    divergences = []
    for r in range(ta.shape[0]):
        differ = (ta[r] != tx[r]).nonzero()
        if len(differ) == 0:
            continue
        i = int(differ[0])
        top2 = sx[r, i].topk(2).values
        gap = (top2[0] - top2[1]).item()
        step_err = (sa[r, i] - sx[r, i]).abs().max().item()
        divergences.append(dict(row=r, step=i, top2_gap=gap,
                                logit_err=step_err,
                                near_tie=gap <= 2 * step_err))
    emit(phase="parity_generate_ssm_f32_divergences",
         divergences=divergences)
    fail_unless(all(d["near_tie"] for d in divergences),
                f"ssm full-depth f32: a divergence that is not a near-tie: "
                f"{divergences}")
    return dict(full_f32_prefill_logits_kernel_vs_xla_max_abs_err=err,
                full_f32_prefill_logits_scale=scale,
                full_f32_logits_tol=FULL_F32_LOGITS_TOL,
                full_f32_greedy_token_agreement=float((ta == tx).float()
                                                      .mean()),
                full_f32_first_tokens_equal=True,
                full_f32_divergences=len(divergences))


def phase_parity_generate_ssm(model):
    cfg = get_config(SSM_ARCH)
    rng = np.random.default_rng(6)
    # published width, depth 2, f32, a 300-token prompt: card (kernel) vs
    # CPU (the model's chunked path)
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    m_gpu = tfm.init_lm(cfg2, 0, device="cuda")
    m_cpu = tfm.LM(cfg2, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    prompts = rng.integers(0, cfg.vocab, (2, 300)).astype(np.int32)
    ssd_mod.launches = 0
    lg, tg, _ = _greedy_lockstep(m_gpu, prompts, 8)
    fail_unless(ssd_mod.launches > 0, "ssm parity: the card's run went "
                                      "through the SSD kernel")
    lc, tc, _ = _greedy_lockstep(m_cpu.eval(), prompts, 8)
    err = (lg - lc).abs().max().item()
    fail_unless(bool(torch.isfinite(lg).all()) and err <= LOGITS_TOL,
                f"ssm depth-2 f32 prefill logits card vs CPU: {err}")
    fail_unless(torch.equal(tg, tc), "ssm depth-2 f32 greedy tokens card "
                                     "vs CPU")
    del m_gpu, m_cpu
    prompts = rng.integers(0, cfg.vocab, (8, 300)).astype(np.int32)
    f32_gate = _full_depth_f32_gate(cfg, prompts)
    # the served model, full depth, bf16: the kernel vs the model's path
    res = {}
    for impl in ("auto", "xla"):
        model.attn_impl = impl
        c = tfm.init_cache(model.cfg, 8, 512, device="cuda")
        logits, _ = model.prefill(prompts, c)
        toks = GenerationEngine(model.cfg, model, max_seq=512,
                                device="cuda").generate(prompts, 16)
        res[impl] = (logits.float(), toks)
    model.attn_impl = "auto"
    full_err = (res["auto"][0] - res["xla"][0]).abs().max().item()
    fail_unless(bool(torch.isfinite(res["auto"][0]).all()),
                "ssm full-depth bf16 logits finite")
    emit(phase="parity_generate_ssm", prompt_len=300,
         depth2_f32_prefill_logits_card_vs_cpu_max_abs_err=err,
         depth2_f32_greedy_tokens_equal=True, **f32_gate,
         full_bf16_prefill_logits_kernel_vs_xla_max_abs_err=full_err,
         full_bf16_greedy_token_agreement=float(
             (res["auto"][1] == res["xla"][1]).mean()),
         full_bf16_first_tokens_equal=bool(
             (res["auto"][1][:, 0] == res["xla"][1][:, 0]).all()))


def phase_breakdown_generate_ssm(model, peaks):
    """One mamba2 decode step at 8 slots of the served model: device time
    (graph replay) and time from Python, beside the least bytes it must
    move (the weights read once, the f32 state read and written once)."""
    cfg = model.cfg
    B = 8
    cache = tfm.init_cache(cfg, B, 128, device="cuda")
    model.prefill(np.random.default_rng(3).integers(0, cfg.vocab, (B, 16)),
                  cache)
    tok = torch.zeros(B, 1, dtype=torch.long, device="cuda")
    pos = torch.full((B,), 16, dtype=torch.long, device="cuda")

    def step():
        model.decode_step(tok, cache, pos)

    step_call = time_ms(step, 10)
    step_dev = graph_ms(step, 1, replays=10)
    wbytes = sum(t.numel() * t.element_size() for t in model.parameters())
    sbytes = (cache.h.numel() + cache.conv.numel()) * 4
    try:
        prof = _profile_step(step)
    except Exception as e:          # the profiler is untried on the card
        prof = {"error": repr(e)[:200]}
    emit(phase="breakdown_generate_ssm", slots=B, layers=cfg.n_layers,
         step_ms=step_dev, step_call_ms=step_call,
         device_busy_share_of_call=step_dev / step_call,
         weight_bytes=wbytes, state_bytes=sbytes,
         bytes_bound_ms=(wbytes + 2 * sbytes) / peaks["hbm"] * 1e3,
         profiler=prof if prof is not None else "no device time recorded")


# ---------------------------------------------------------------------------
# the MoE and MLA families: granite-moe-3b-a800m and minicpm3-4b
# ---------------------------------------------------------------------------

MOE_ARCH, MLA_ARCH = "granite-moe-3b-a800m", "minicpm3-4b"
# one MoE layer in f32, card against CPU: the same products over D = 1536
# and F = 512 summed in another order, a difference of order 1e-6 of
# outputs of order 1; a token routed to another expert row moves its
# output by its own size
MOE_LAYER_TOL = 1e-4
_COUNTERS = ((fa_mod, "launches"), (da_mod, "launches"),
             (da_mod, "paged_launches"), (da_mod, "chunk_launches"),
             (da_mod, "gqa_launches"), (ssd_mod, "launches"),
             (ld_mod, "launches"), (ld_mod, "merge_launches"))


def _zero_counters() -> None:
    for mod, name in _COUNTERS:
        setattr(mod, name, 0)


def _attention_launches() -> dict:
    return {"flash_attention": fa_mod.launches,
            "decode_attention": da_mod.launches,
            "paged_decode_attention": da_mod.paged_launches,
            "decode_attention_chunk": da_mod.chunk_launches,
            "decode_attention_gqa_body": da_mod.gqa_launches,
            "ssd_scan": ssd_mod.launches,
            "latent_decode": ld_mod.launches}


def phase_moe_layer():
    """One granite MoE layer at published width in f32 (D 1536, 40 experts
    of 512, top-8), seeded weights, on the card and on the CPU from the
    same weights and inputs: one refill wave's 128 tokens at capacity
    factor 0.5 (12 rows per expert for 1,024 assignments: tokens drop)
    and at the config's 1.25, and a decode step's 8 at 0.5 (the capacity
    is the group, 8: nothing can drop).  The routing (expert, row, kept)
    equal, the outputs within MOE_LAYER_TOL, the dropped count printed
    beside the card's ms (graph replay)."""
    from repro_torch.models import moe as moe_mod
    cfg = get_config(MOE_ARCH)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = moe_mod.MoEParams(D, E, F, device="cuda")
    p.reset_parameters(gen)
    pc = moe_mod.MoEParams(D, E, F, device="cpu")
    pc.load_state_dict({k: v.cpu() for k, v in p.state_dict().items()})
    rows = []
    for n, cf in ((128, 0.5), (8, 0.5), (128, cfg.capacity_factor)):
        x = torch.from_numpy(np.random.default_rng(n).standard_normal(
            (1, n, D)).astype(np.float32))
        xg = x.cuda()
        r_card = moe_mod.route(p.router, xg, cfg.top_k, cf)
        r_cpu = moe_mod.route(pc.router, x, cfg.top_k, cf)
        same = [torch.equal(a.cpu(), b) for a, b in zip(r_card[2:5],
                                                        r_cpu[2:5])]
        fail_unless(all(same), f"moe_layer n={n} cf={cf}: routing card == "
                               f"CPU (experts, rows, kept): {same}")
        y, aux = moe_mod.moe_forward(p, xg, top_k=cfg.top_k,
                                     capacity_factor=cf)
        yc, auxc = moe_mod.moe_forward(pc, x, top_k=cfg.top_k,
                                       capacity_factor=cf)
        torch.cuda.synchronize()
        err = (y.cpu() - yc).abs().max().item()
        fail_unless(bool(torch.isfinite(y).all()) and err <= MOE_LAYER_TOL,
                    f"moe_layer n={n} cf={cf}: card vs CPU {err}")
        dropped = int((~r_card[4]).sum())
        if (n, cf) == (128, 0.5):
            fail_unless(dropped > 0, f"moe_layer n={n} cf={cf}: tokens "
                                     f"dropped")
        ms = graph_ms(lambda: moe_mod.moe_forward(  # noqa: B023
            p, xg, top_k=cfg.top_k, capacity_factor=cf, need_aux=False), 20)
        rows.append(dict(tokens=n, capacity_factor=cf, capacity=r_card[5],
                         assignments=n * cfg.top_k, dropped=dropped,
                         dropped_cpu=int((~r_cpu[4]).sum()),
                         routing_equal=True, max_abs_err=err,
                         max_abs_y=y.abs().max().item(), tol=MOE_LAYER_TOL,
                         aux_card=aux.item(), aux_cpu=auxc.item(), ms=ms))
    emit(phase="moe_layer", arch=MOE_ARCH, d_model=D, experts=E,
         d_ff_expert=F, top_k=cfg.top_k, dtype="float32", cases=rows)
    del p, pc


def _weight_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in model.parameters())


def _step_profile(model, peaks) -> dict:
    """One decode step of the served model at 8 slots after a 16-token
    prefill: device ms (graph replay), ms from Python, the profiler's
    kernels, and the weight bytes beside their read at the HBM peak (the
    step's least time: an MoE step reads every expert, as the dense
    dispatch does)."""
    cfg = model.cfg
    B = 8
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B, 16))
    cache = tfm.init_cache(cfg, B, serve.GEN_MAX_SEQ, device="cuda")
    model.prefill(prompts, cache)
    tok = torch.zeros(B, 1, dtype=torch.long, device="cuda")
    pos = torch.full((B,), 16, dtype=torch.long, device="cuda")

    def step():
        model.decode_step(tok, cache, pos)

    call = time_ms(step, 5)
    dev = graph_ms(step, 1, replays=10)
    try:
        prof = _profile_step(step)
    except Exception as e:          # the profiler is untried on the card
        prof = {"error": repr(e)[:200]}
    wbytes = _weight_bytes(model)
    return dict(step_ms=dev, step_call_ms=call,
                device_busy_share_of_call=dev / call,
                kernels_per_step=(prof or {}).get("kernels"),
                weight_bytes=wbytes,
                weight_bytes_bound_ms=wbytes / peaks["hbm"] * 1e3,
                profiler=prof if prof is not None
                else "no device time recorded")


def _serve_family(arch, extra, phase, kernels, peaks):
    """The launcher's generate run of ``arch`` at published width (32
    requests of 16 + 16 tokens over 8 slots, bio controller), the launch
    counters zeroed just before and read just after: every request
    answered, 1..16 ids inside the vocabulary, the window one captured
    graph, every kernel of ``kernels`` launched and no other; -> (the
    launches, the served model)."""
    args = serve.parser().parse_args(
        ["--device", "cuda", "--mode", "generate", "--arch", arch,
         "--requests", "32", "--new-tokens", "16", "--slots", "8",
         "--controller", "bio", *extra])
    _zero_counters()
    t0 = time.perf_counter()
    summary, server = serve.serve_generate(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _attention_launches()
    cfg = get_config(arch)
    resp = server.responses
    fail_unless(sorted(r.rid for r in resp) == list(range(args.requests)),
                f"{phase}: every request answered once")
    admitted = [r for r in resp if r.admitted]
    fail_unless(len(admitted) > 0 and all(
        isinstance(r.output, list) and 1 <= len(r.output) <= args.new_tokens
        and all(0 <= t < cfg.vocab for t in r.output) for r in admitted),
        f"{phase}: 1..16 token ids inside the vocabulary each")
    fail_unless(all((launches[k] > 0) == (k in kernels) for k in launches),
                f"{phase}: launched exactly {kernels}: {launches}")
    fail_unless(summary["window"] == "graph" and summary["captures"] == 1,
                f"{phase}: the window one captured graph: {summary}")
    model = server.engine.engine.params
    fail_unless(model.cfg.n_layers == cfg.n_layers
                and model.cfg.d_model == cfg.d_model
                and model.emb.dtype == torch.bfloat16,
                f"{phase}: published width, every layer, bf16")
    if "--kv-block-size" in extra:
        fail_unless(summary["blocks_allocated"] == summary["blocks_freed"],
                    f"{phase}: every block given back: {summary}")
    steps_run = summary["host_syncs"] * server.engine.engine.sync_every
    decode_s = summary["device_s"] - summary["prefill_s"]
    wbytes = _weight_bytes(model)
    emit(phase=phase, seconds=secs, launches=launches,
         admitted=len(admitted),
         tokens_per_busy_s=summary["tokens_generated"] / summary["busy_s"],
         decode_ms_per_step=decode_s / steps_run * 1e3,
         prefill_ms_per_call=(summary["prefill_s"]
                              / summary["prefill_calls"] * 1e3),
         weight_bytes=wbytes,
         weight_bytes_bound_ms=wbytes / peaks["hbm"] * 1e3,
         nvidia_smi=nvidia_smi("name,power.limit"), **summary)
    del server
    return launches, model


def _engine_tokens(cfg, model, *, capture="auto", sampled=False):
    """16 requests of 16 + 16 tokens through a fresh 8-slot engine."""
    eng = cont.ContinuousBatchingEngine(cfg, model, n_slots=8,
                                        max_seq=serve.GEN_MAX_SEQ,
                                        device=model.device, capture=capture)
    reqs = _graph_requests(cfg.vocab, sampled)
    eng.serve(reqs, prompt_len=serve.GEN_PROMPT_LEN)
    return [r.generated for r in reqs]


def _f32_caches():
    """Patch ``tfm.init_cache`` to f32 caches; -> the original."""
    init_cache = tfm.init_cache
    tfm.init_cache = functools.partial(init_cache, dtype=torch.float32)
    return init_cache


def phase_parity_generate_moe(model):
    """granite at published width, depth 2, f32 weights and caches, TF32
    off: the kernel path (``attn_impl="auto"``, flash and flash-decode,
    the window captured) against the kernels' plain versions
    (``attn_impl="ref"``, uncaptured) on the same weights, 16 requests of
    16 + 16 tokens: equal greedy tokens for every request, and the
    lockstep logits' largest difference printed.  The served model at
    full depth in bf16: lockstep greedy agreement of the two paths,
    printed."""
    cfg = get_config(MOE_ARCH)
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    fail_unless(not tf32, "parity_generate_moe: TF32 off")
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    m = tfm.init_lm(cfg2, 0, device="cuda")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (8, 16))
    toks, launches, lock = {}, {}, {}
    for impl, capture in (("auto", "auto"), ("ref", False)):
        m.attn_impl = impl
        _zero_counters()
        init_cache = _f32_caches()
        try:
            toks[impl] = _engine_tokens(cfg2, m, capture=capture)
        finally:
            tfm.init_cache = init_cache
        launches[impl] = _attention_launches()
        lock[impl] = _greedy_lockstep(m, prompts, 8)     # f32 cache
    m.attn_impl = "auto"
    fail_unless(launches["auto"]["flash_attention"] > 0
                and launches["auto"]["decode_attention"] > 0
                and not any(launches["ref"].values()),
                f"parity_generate_moe: kernels on the auto path only: "
                f"{launches}")
    same = [a == b for a, b in zip(toks["auto"], toks["ref"])]
    fail_unless(all(same), f"parity_generate_moe depth-2 f32: kernel path "
                           f"tokens == plain path, per request: {same}")
    prefill_err = (lock["auto"][0] - lock["ref"][0]).abs().max().item()
    step_err = (lock["auto"][2] - lock["ref"][2]).abs().max().item()
    del m
    full = {}
    for impl in ("auto", "ref"):
        model.attn_impl = impl
        full[impl] = _greedy_lockstep(model, prompts, 16,
                                      dtype=torch.bfloat16)[1]
    model.attn_impl = "auto"
    emit(phase="parity_generate_moe", tf32=tf32,
         depth2_f32_requests_equal=sum(same), requests=len(same),
         depth2_f32_lockstep_tokens_equal=bool(
             torch.equal(lock["auto"][1], lock["ref"][1])),
         depth2_f32_prefill_logits_max_abs_err=prefill_err,
         depth2_f32_step_logits_max_abs_err=step_err,
         depth2_launches=launches,
         full_bf16_greedy_token_agreement=float(
             (full["auto"] == full["ref"]).float().mean()))


def phase_parity_generate_mla():
    """minicpm3 at published width, depth 2, f32 weights and caches, TF32
    off, the card against the CPU on the same weights (the card's decode
    steps through the latent decode kernel's f32 instance, no other
    attention kernel; the CPU's through its plain version): 16 requests
    of 16 + 16 tokens through the continuous engine, equal greedy tokens
    for every request, and lockstep logits' largest difference
    printed."""
    cfg = get_config(MLA_ARCH)
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    fail_unless(not tf32, "parity_generate_mla: TF32 off")
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    m_gpu = tfm.init_lm(cfg2, 0, device="cuda")
    m_cpu = tfm.LM(cfg2, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    m_cpu.eval()
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (8, 16))
    init_cache = _f32_caches()
    try:
        _zero_counters()
        toks_gpu = _engine_tokens(cfg2, m_gpu)
        launches = _attention_launches()
        toks_cpu = _engine_tokens(cfg2, m_cpu)
    finally:
        tfm.init_cache = init_cache
    lg = _greedy_lockstep(m_gpu, prompts, 8)                 # f32 caches
    lc = _greedy_lockstep(m_cpu, prompts, 8)
    fail_unless(launches["latent_decode"] > 0 and not any(
        n for k, n in launches.items() if k != "latent_decode"),
                f"parity_generate_mla: the latent decode kernel and no other "
                f"attention kernel: {launches}")
    same = [a == b for a, b in zip(toks_gpu, toks_cpu)]
    fail_unless(all(same), f"parity_generate_mla depth-2 f32: card tokens "
                           f"== CPU, per request: {same}")
    prefill_err = (lg[0] - lc[0]).abs().max().item()
    fail_unless(bool(torch.isfinite(lg[0]).all())
                and prefill_err <= LOGITS_TOL,
                f"parity_generate_mla: prefill logits card vs CPU "
                f"{prefill_err}")
    emit(phase="parity_generate_mla", tf32=tf32,
         depth2_f32_requests_equal=sum(same), requests=len(same),
         depth2_f32_lockstep_tokens_equal=bool(torch.equal(lg[1], lc[1])),
         depth2_f32_prefill_logits_max_abs_err=prefill_err,
         depth2_f32_step_logits_max_abs_err=(lg[2] - lc[2]).abs().max()
         .item(), logits_tol=LOGITS_TOL)
    del m_gpu, m_cpu


def phase_families(peaks) -> dict:
    """This slice's paths: ``moe_layer``; granite-moe-3b-a800m through the
    launcher on the contiguous and the paged pool (``serve_generate_moe``,
    ``serve_generate_moe_paged``), its decode step (``step_moe``),
    ``parity_generate_moe`` and ``decode_graph``; then minicpm3-4b
    through the launcher greedy and sampled (``serve_generate_mla``,
    ``serve_generate_mla_sampled``), its step, ``parity_generate_mla``
    and ``decode_graph``.  Each model is freed before the next is built;
    -> each served path's launches."""
    t0 = time.perf_counter()
    phase_moe_layer()
    launches = {}
    # granite's G = 3 decode runs the GQA body
    launches["serve_generate_moe"], model = _serve_family(
        MOE_ARCH, [], "serve_generate_moe",
        ("flash_attention", "decode_attention", "decode_attention_gqa_body"),
        peaks)
    launches["serve_generate_moe_paged"], paged = _serve_family(
        MOE_ARCH, ["--kv-block-size", str(PAGED_BS)],
        "serve_generate_moe_paged",
        ("flash_attention", "paged_decode_attention",
         "decode_attention_gqa_body"), peaks)
    del paged
    torch.cuda.empty_cache()
    emit(phase="step_moe", arch=MOE_ARCH, slots=8,
         **_step_profile(model, peaks))
    phase_parity_generate_moe(model)
    phase_decode_graph(MOE_ARCH, model.cfg, model)
    del model
    torch.cuda.empty_cache()
    launches.update(phase_mla_family(peaks))
    emit(phase="families", seconds=time.perf_counter() - t0)
    return launches


def phase_mla_family(peaks) -> dict:
    """minicpm3-4b through the launcher greedy and sampled
    (``serve_generate_mla``, ``serve_generate_mla_sampled``: the latent
    decode kernel and no other attention kernel), its step
    (``step_mla``), ``parity_generate_mla`` and ``decode_graph``; -> each
    served path's launches."""
    sampled = ["--temperature", str(SAMPLED["temperature"]), "--top-k",
               str(SAMPLED["top_k"]), "--top-p", str(SAMPLED["top_p"])]
    launches = {}
    launches["serve_generate_mla"], model = _serve_family(
        MLA_ARCH, [], "serve_generate_mla", ("latent_decode",), peaks)
    launches["serve_generate_mla_sampled"], other = _serve_family(
        MLA_ARCH, sampled, "serve_generate_mla_sampled", ("latent_decode",),
        peaks)
    del other
    torch.cuda.empty_cache()
    emit(phase="step_mla", arch=MLA_ARCH, slots=8,
         **_step_profile(model, peaks))
    phase_parity_generate_mla()
    phase_decode_graph(MLA_ARCH, model.cfg, model)
    del model
    torch.cuda.empty_cache()
    return launches


# the latent decode kernel against its plain version, relative to each
# row's largest output: tests/test_torch_latent_decode.py's ROW_TOL (both
# take exact products in f32 and differ by summation order, exp2 against
# exp and the three-part weights' last bit, ~1e-6 of a row; one dropped
# live row of ~1,000 moves a row by ~1e-2)
LATENT_ROW_TOL = 1e-4
LATENT_ARCH = "moonlight-16b-a3b"
# (case, heads, r, rope, nope, slots, rows, cache dtype): the benchmark
# cell's shape (Moonlight, 256 slots of 2048 rows) in bf16 and in f32, and
# MiniCPM3's widths
LATENT_CASES = (("moonlight_bf16", 16, 512, 64, 128, 256, 2048, torch.bfloat16),
                ("moonlight_f32", 16, 512, 64, 128, 256, 2048, torch.float32),
                ("minicpm3_bf16", 40, 256, 32, 64, 64, 2048, torch.bfloat16))


def phase_latent_decode(peaks) -> list:
    """The MLA latent decode kernel at ``LATENT_CASES``, each slot's
    position a prompt of 64-1024 tokens plus up to 1,000 outputs (the
    backlog's), its rows [0, pos] live: the row-scaled error against the
    plain version, device ms (graph replay) beside the bound (the live
    rows' latent, rotary part and position, q and the f32 output once
    each at the HBM peak), the plain version's ms, and the kernel's and
    the merge's launches for one call."""
    out = []
    for name, H, r, rope, nope, B, C, dt in LATENT_CASES:
        rng = np.random.default_rng(34)
        cur = np.minimum(rng.integers(64, 1025, B)
                         + rng.integers(0, 1001, B) - 1, C - 1)
        g = torch.Generator(device="cuda").manual_seed(34)

        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=g).to(dt)

        q, qr, c, kr = rand(B, 1, H, r), rand(B, 1, H, rope), rand(B, C, r), \
            rand(B, C, rope)
        cur_t = torch.from_numpy(cur.astype(np.int32)).cuda()
        rows = torch.arange(C, device="cuda", dtype=torch.int32)
        kv_pos = torch.where(rows[None] <= cur_t[:, None], rows[None],
                             -1).to(torch.int32)
        scale = 1.0 / math.sqrt(nope + rope)
        args = (q, qr, c, kr, kv_pos, cur_t)
        ld_mod.launches = ld_mod.merge_launches = 0
        got = ld_mod.latent_decode(*args, scale=scale)
        torch.cuda.synchronize()
        launches = {"launches": ld_mod.launches,
                    "merge_launches": ld_mod.merge_launches}
        want = ld_mod.latent_decode_plain(*args, scale=scale)
        err = row_scaled_error(got, want)
        fail_unless(bool(torch.isfinite(got).all()) and err <= LATENT_ROW_TOL,
                    f"latent_decode {name}: kernel vs plain {err}")
        ms = graph_ms(lambda: ld_mod.latent_decode(  # noqa: B023
            *args, scale=scale), 20)
        plain_ms = graph_ms(lambda: ld_mod.latent_decode_plain(  # noqa: B023
            *args, scale=scale), 2, replays=3)
        live = int((cur + 1).sum())
        nbytes = (live * ((r + rope) * c.element_size() + 4)
                  + B * H * (r + rope) * q.element_size() + B * H * r * 4)
        bound_ms = nbytes / peaks["hbm"] * 1e3
        row = dict(case=name, slots=B, rows=C, heads=H, r=r, rope=rope,
                   cache_dtype=str(dt).replace("torch.", ""),
                   live_rows=live, live_share=live / (B * C),
                   row_scaled_error=err, tol=LATENT_ROW_TOL, ms=ms,
                   bound_ms=bound_ms, roofline_pct=100.0 * bound_ms / ms,
                   plain_ms=plain_ms, launches=launches)
        emit(phase="latent_decode", **row,
             nvidia_smi=nvidia_smi("name,power.limit"))
        out.append(row)
        del q, qr, c, kr, args, got, want
        torch.cuda.empty_cache()
    # the cell's model whole (27 MLA layers, seeded) through the engine:
    # the latent launches equal layers x steps, the window captured and
    # replayed
    cfg = get_config(LATENT_ARCH)
    model = tfm.init_lm(cfg, 0, device="cuda")
    phase_decode_graph(LATENT_ARCH, cfg, model)
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the rest of the model families: recurrentgemma-2b (RG-LRU + windowed
# attention), paligemma-3b (prefix-LM), whisper-medium (encoder-decoder)
# ---------------------------------------------------------------------------

HYBRID_ARCH, VLM_ARCH, ENCDEC_ARCH = ("recurrentgemma-2b", "paligemma-3b",
                                      "whisper-medium")
RING_PROMPT, RING_NEW = 3000, 32      # past the 2048 window, then 32 more
N_PATCHES = 256                       # paligemma's patch embeddings


def _lockstep_gate(tag, a, b, tol=FULL_F32_LOGITS_TOL) -> dict:
    """Two lockstep greedy runs of one model (``_greedy_lockstep``'s
    results) held to each other: the prefill logits within ``tol`` of
    ``b``'s largest |logit|, the first tokens equal, and each row's first
    divergence a near-tie (``b``'s top-2 gap there at most twice the
    step's largest logit difference), as ``_full_depth_f32_gate`` judges
    mamba2; -> the numbers."""
    (la, ta, sa), (lb, tb, sb) = a, b
    scale = lb.abs().max().item()
    err = (la - lb).abs().max().item()
    fail_unless(bool(torch.isfinite(la).all()) and err <= tol * scale,
                f"{tag}: prefill logits {err} > {tol} x {scale}")
    fail_unless(torch.equal(ta[:, 0], tb[:, 0]), f"{tag}: first tokens equal")
    divergences = []
    for r in range(ta.shape[0]):
        differ = (ta[r] != tb[r]).nonzero()
        if len(differ) == 0:
            continue
        i = int(differ[0])
        top2 = sb[r, i].topk(2).values
        gap = (top2[0] - top2[1]).item()
        step_err = (sa[r, i] - sb[r, i]).abs().max().item()
        divergences.append(dict(row=r, step=i, top2_gap=gap,
                                logit_err=step_err,
                                near_tie=gap <= 2 * step_err))
    fail_unless(all(d["near_tie"] for d in divergences),
                f"{tag}: a divergence that is not a near-tie: {divergences}")
    return dict(prefill_logits_max_abs_err=err, prefill_logits_scale=scale,
                logits_tol=tol, first_tokens_equal=True,
                token_agreement=float((ta == tb).float().mean()),
                step_logits_max_abs_err=(sa - sb).abs().max().item(),
                divergences=divergences)


def _card_and_cpu(cfg):
    """``cfg`` in f32 seeded on the card, and the same weights on the
    CPU."""
    m_gpu = tfm.init_lm(cfg, 0, device="cuda")
    m_cpu = tfm.LM(cfg, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    return m_gpu, m_cpu.eval()


def _rglru_blocks(model, B=8) -> dict:
    """The decode step's RG-LRU blocks alone (each recurrent layer's
    norm and ``rglru_block`` from its own state, one token per slot):
    device ms by graph replay and the profiler's kernels."""
    from repro_torch.models import rglru
    layers = [layer for layer in model.layers if layer.kind == "rglru"]
    cfg = model.cfg
    x = torch.randn(B, 1, cfg.d_model, device="cuda").to(model.emb.dtype)
    states = [rglru.init_rglru_state(B, cfg.lru_width or cfg.d_model,
                                     cfg.conv_width, device="cuda")
              for _ in layers]

    def blocks():
        for layer, st in zip(layers, states):
            rglru.rglru_block(layer.mix, layer.norm1(x), st, single_step=True)

    prof = _profile_step(blocks)
    return dict(rglru_layers=len(layers),
                rglru_blocks_ms=graph_ms(blocks, 1, replays=10),
                rglru_kernels=(prof or {}).get("kernels"))


def phase_ring_generate_hybrid():
    """recurrentgemma at published width, depth 3 (one whole pattern:
    rglru, rglru, local_attn), f32 weights and caches, TF32 off, on the
    card: 2 prompts of 3,000 tokens prefilled through the windowed flash
    kernel (S past the 2048 window) into the 2048-row ring, then 32
    greedy tokens read from the wrapped ring by flash-decode, against the
    kernels' plain versions (``attn_impl="ref"``) on the same weights:
    ``_lockstep_gate``."""
    cfg = get_config(HYBRID_ARCH).replace(n_layers=3, dtype="float32")
    fail_unless(not torch.backends.cuda.matmul.allow_tf32,
                "ring_generate_hybrid: TF32 off")
    m = tfm.init_lm(cfg, 0, device="cuda")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab,
                                                (2, RING_PROMPT))
    res, launches, secs = {}, {}, {}
    for impl in ("auto", "ref"):
        m.attn_impl = impl
        _zero_counters()
        t0 = time.perf_counter()
        res[impl] = _greedy_lockstep(m, prompts, RING_NEW)
        secs[impl] = time.perf_counter() - t0
        launches[impl] = _attention_launches()
    m.attn_impl = "auto"
    fail_unless(launches["auto"]["flash_attention"] == 1
                and launches["auto"]["decode_attention"] == RING_NEW
                and not any(launches["ref"].values()),
                f"ring_generate_hybrid: the kernels on the auto path only: "
                f"{launches}")
    gate = _lockstep_gate("ring_generate_hybrid", res["auto"], res["ref"])
    emit(phase="ring_generate_hybrid", arch=HYBRID_ARCH, layers=3,
         kinds=list(cfg.block_kinds), d_model=cfg.d_model, window=cfg.window,
         prompt=RING_PROMPT, new_tokens=RING_NEW, ring_rows=cfg.window,
         dtype="float32", launches=launches, seconds=secs, **gate)
    del m


def phase_prefix_generate_vlm():
    """paligemma at published width, depth 2, f32 weights and caches, TF32
    off, the card against the CPU on the same weights: 4 prompts of 16
    tokens after 256 seeded patch embeddings (the prefix-LM mask, on the
    einsum path on both sides: no flash launch), then 16 greedy tokens
    (flash-decode on the card): ``_lockstep_gate``."""
    cfg = get_config(VLM_ARCH).replace(n_layers=2, dtype="float32")
    fail_unless(not torch.backends.cuda.matmul.allow_tf32,
                "prefix_generate_vlm: TF32 off")
    m_gpu, m_cpu = _card_and_cpu(cfg)
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, cfg.vocab, (4, 16))
    patches = (0.1 * rng.standard_normal((4, N_PATCHES, cfg.d_model))
               ).astype(np.float32)
    _zero_counters()
    card = _greedy_lockstep(m_gpu, prompts, 16, prefix_embeds=patches)
    launches = _attention_launches()
    cpu = _greedy_lockstep(m_cpu, prompts, 16, prefix_embeds=patches)
    fail_unless(launches["flash_attention"] == 0
                and launches["decode_attention"] == 2 * 16,
                f"prefix_generate_vlm: the prefix on the einsum path, every "
                f"step through flash-decode: {launches}")
    gate = _lockstep_gate("prefix_generate_vlm", card, cpu)
    emit(phase="prefix_generate_vlm", arch=VLM_ARCH, layers=2,
         d_model=cfg.d_model, patches=N_PATCHES, prompt=16, new_tokens=16,
         dtype="float32", launches=launches, **gate)
    del m_gpu, m_cpu


def phase_encdec_generate(peaks) -> dict:
    """whisper-medium at published width (24 + 24 layers, d 1024, bf16,
    seeded) through the model API on 4 rows of 1,500 seeded frame
    embeddings: ``encode``, ``compute_cross_kv``, a 16-token prefill
    (flash on the decoder's self-attention, hd 64) and 16 greedy decode
    steps (flash-decode, 16 heads of 64); ms of the encoder (graph
    replay), per prefill (the encoder included) and per decode step (from
    Python, and one step by graph replay, with the profiler's sums),
    launches,
    finite logits and ids inside the vocabulary.  Then depth 2 (2 + 2
    layers) in f32, the card against the CPU: ``_lockstep_gate``; ->
    the launches of the published-width run."""
    cfg = get_config(ENCDEC_ARCH)
    rng = np.random.default_rng(12)
    B = 4
    frames = (0.1 * rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
              ).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab, (B, 16))
    m = tfm.init_lm(cfg, 0, device="cuda")
    fail_unless(m.cfg.n_layers == 24 and m.cfg.n_enc_layers == 24
                and m.emb.dtype == torch.bfloat16,
                "encdec_generate: published width, 24 + 24 layers, bf16")
    x = torch.from_numpy(frames).cuda()
    toks = torch.from_numpy(prompts).cuda()
    enc_ms = graph_ms(lambda: m.encode(x), 1)
    enc_out = m.encode(x)
    cross_ms = graph_ms(lambda: m.compute_cross_kv(enc_out), 1)
    _zero_counters()
    cache = tfm.init_cache(cfg, B, 64, device="cuda")
    prefill_ms = time_ms(lambda: m.prefill(toks, cache, enc_embeds=x), 3)
    _zero_counters()
    logits, cache = m.prefill(toks, cache, enc_embeds=x)
    tok = logits[:, -1].argmax(-1)[:, None]
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(16):
        out.append(tok[:, 0])
        logits, cache = m.decode_step(tok, cache, 16 + i)
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 16 * 1e3
    launches = _attention_launches()
    at = torch.full((B,), 32, dtype=torch.long, device="cuda")
    step_device_ms = graph_ms(lambda: m.decode_step(tok, cache, at), 1)
    try:
        prof = _profile_step(lambda: m.decode_step(tok, cache, at))
    except Exception as e:          # the profiler is untried on the card
        prof = {"error": repr(e)[:200]}
    ids = torch.stack(out, 1)
    fail_unless(bool(torch.isfinite(logits.float()).all())
                and bool(((ids >= 0) & (ids < cfg.vocab)).all()),
                "encdec_generate: finite logits, ids inside the vocabulary")
    fail_unless(launches["flash_attention"] == 24
                and launches["decode_attention"] == 24 * 16,
                f"encdec_generate: flash in each decoder layer's prefill, "
                f"flash-decode in each step: {launches}")
    wbytes = _weight_bytes(m)
    del m, cache, enc_out
    torch.cuda.empty_cache()
    cfg2 = cfg.replace(n_layers=2, n_enc_layers=2, dtype="float32")
    fail_unless(not torch.backends.cuda.matmul.allow_tf32,
                "encdec_generate: TF32 off")
    m_gpu, m_cpu = _card_and_cpu(cfg2)
    card = _greedy_lockstep(m_gpu, prompts, 16, enc_embeds=frames)
    cpu = _greedy_lockstep(m_cpu, prompts, 16, enc_embeds=frames)
    gate = _lockstep_gate("encdec_generate depth-2 f32", card, cpu)
    del m_gpu, m_cpu
    emit(phase="encdec_generate", arch=ENCDEC_ARCH, rows=B,
         frames=cfg.enc_seq, enc_layers=24, dec_layers=24,
         d_model=cfg.d_model, encoder_ms=enc_ms, cross_kv_ms=cross_ms,
         prefill_ms=prefill_ms, decode_ms_per_step=step_ms,
         decode_step_device_ms=step_device_ms,
         decode_step_profiler=prof if prof is not None
         else "no device time recorded", launches=launches, sample=ids[0, :8].tolist(), weight_bytes=wbytes,
         weight_bytes_bound_ms=wbytes / peaks["hbm"] * 1e3,
         depth2_f32=gate, nvidia_smi=nvidia_smi("name,power.limit"))
    return launches


def _prefill_share(model, B: int, S: int) -> dict:
    """One prefill of B seeded prompts of S tokens through the served
    model (published width, bf16) into a fresh cache: ms from the host
    around a synchronised call after a warm one, and the flash kernel's
    share of the call's device time by the profiler."""
    cfg = model.cfg
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (B, S))
    cache = tfm.init_cache(cfg, B, max(S + 16, serve.GEN_MAX_SEQ),
                           device="cuda")

    def prefill():
        model.prefill(prompts, cache)

    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    try:
        prof = _profile_step(prefill, attention="flash")
    except Exception as e:          # the profiler is untried on the card
        prof = {"error": repr(e)[:200]}
    if prof is None or "error" in prof:
        return dict(prompts=B, tokens=S, call_ms=ms,
                    profiler=prof or "no device time recorded")
    device_ms = prof["attention_ms"] + prof["products_ms"] + prof["rest_ms"]
    return dict(prompts=B, tokens=S, call_ms=ms, device_ms=device_ms,
                flash_ms=prof["attention_ms"],
                flash_share_of_device=prof["attention_ms"] / device_ms)


def phase_new_families(peaks) -> dict:
    """This slice's paths, each model freed before the next is built:
    recurrentgemma-2b through the launcher greedy and sampled
    (``serve_generate_hybrid``, ``_sampled``: flash and flash-decode),
    its decode step (``step_hybrid``, with the RG-LRU blocks alone),
    ``decode_graph`` and ``ring_generate_hybrid``; paligemma-3b through
    the launcher on the contiguous pool, a paged pool of 16-row blocks
    and with ``--draft-depth 3 --draft-layers 6``
    (``serve_generate_vlm``, ``_paged``, ``_spec``), ``step_vlm``,
    ``decode_graph`` and ``prefix_generate_vlm``; then
    ``encdec_generate``; -> each served path's launches."""
    t0 = time.perf_counter()
    launches = {}
    sampled = ["--temperature", str(SAMPLED["temperature"]), "--top-k",
               str(SAMPLED["top_k"]), "--top-p", str(SAMPLED["top_p"])]
    attn2 = ("flash_attention", "decode_attention")
    launches["serve_generate_hybrid"], model = _serve_family(
        HYBRID_ARCH, [], "serve_generate_hybrid", attn2, peaks)
    launches["serve_generate_hybrid_sampled"], other = _serve_family(
        HYBRID_ARCH, sampled, "serve_generate_hybrid_sampled", attn2, peaks)
    del other
    torch.cuda.empty_cache()
    emit(phase="prefill_share_hybrid", arch=HYBRID_ARCH,
         served=_prefill_share(model, 8, 16),
         long=_prefill_share(model, 1, RING_PROMPT))
    emit(phase="step_hybrid", arch=HYBRID_ARCH, slots=8,
         **_step_profile(model, peaks), **_rglru_blocks(model))
    phase_decode_graph(HYBRID_ARCH, model.cfg, model)
    del model
    torch.cuda.empty_cache()
    phase_ring_generate_hybrid()
    torch.cuda.empty_cache()
    launches["serve_generate_vlm"], model = _serve_family(
        VLM_ARCH, [], "serve_generate_vlm", attn2, peaks)
    launches["serve_generate_vlm_paged"], other = _serve_family(
        VLM_ARCH, ["--kv-block-size", str(PAGED_BS)],
        "serve_generate_vlm_paged",
        ("flash_attention", "paged_decode_attention"), peaks)
    del other
    launches["serve_generate_vlm_spec"], other = _serve_family(
        VLM_ARCH, ["--draft-depth", "3", "--draft-layers", "6"],
        "serve_generate_vlm_spec",
        ("flash_attention", "decode_attention", "decode_attention_chunk"),
        peaks)
    del other
    torch.cuda.empty_cache()
    emit(phase="prefill_share_vlm", arch=VLM_ARCH,
         served=_prefill_share(model, 8, 16))
    emit(phase="step_vlm", arch=VLM_ARCH, slots=8,
         **_step_profile(model, peaks))
    phase_decode_graph(VLM_ARCH, model.cfg, model)
    del model
    torch.cuda.empty_cache()
    phase_prefix_generate_vlm()
    torch.cuda.empty_cache()
    launches["encdec_generate"] = phase_encdec_generate(peaks)
    torch.cuda.empty_cache()
    emit(phase="new_families", seconds=time.perf_counter() - t0)
    return launches


# -- training: the LM train step, checkpoints, int8 ---------------------------

TRAIN_ARCHS = (SSM_ARCH, MOE_ARCH, MLA_ARCH, HYBRID_ARCH, VLM_ARCH,
               ENCDEC_ARCH)
PARITY_LR = 1e-3
# one train step in f32, card against CPU from the same weights and
# batch: other sum orders (GEMM tiles, the embedding gradient's
# scatter-add) move the loss and norm by about 1e-7 relative and each
# gradient element by a few 1e-6 of its leaf's largest; the gates leave
# a margin of 10-100.  A parameter moves by the learning rate times
# g / (|g| + 1e-8): where the clipped |g| >= 100 x 1e-8 (the first
# moment, 0.1 g, >= 1e-7) that is within 1 % of lr * sign(g) and moves
# by under 1e-9 for a gradient difference of 1e-6 of its size, so the
# parameters agree to f32's rounding (1e-6); nearer 0 the step turns
# on the gradient's rounding noise (1 / 1e-8 per unit of g: about 0.1 lr
# at this shape), so there only its length is bounded, by 2.1 lr
TRAIN_LOSS_RTOL = 1e-5
TRAIN_NORM_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-4
TRAIN_WELL_M = 0.1 * 100 * 1e-8
TRAIN_PARAM_TOL = 1e-6
TRAIN_BOUNDED_STEP = 2.1 * PARITY_LR
TRAIN_LM_ARGS = ["--arch", ARCH, "--full-config", "--steps", "20",
                 "--batch", "8", "--seq", "512"]


def _lm_batch(cfg, batch: int, seq: int, dev, seed: int = 0) -> dict:
    """A ``lm_batches`` batch on ``dev`` with the launcher's frontend
    stubs."""
    tokens = next(lm_batches(vocab=cfg.vocab, batch=batch, seq_len=seq,
                             seed=seed))
    return {"tokens": torch.from_numpy(tokens).to(dev),
            **train_launch.frontends(cfg, batch, torch.device(dev))}


def _no_kernel_launched(tag: str) -> dict:
    """The kernels' counters since the last ``_zero_counters``: a train
    step launches none (no kernel has a backward)."""
    launches = _attention_launches()
    fail_unless(not any(launches.values()),
                f"{tag}: the train path launched a kernel: {launches}")
    return launches


def phase_train_parity():
    """One train step of stablelm-3b at published width, depth 2, f32,
    on the card and on the CPU from the same weights and batch (2 x 64
    tokens): loss, aux, grad norm, the first moments (the clipped
    gradients) and the parameters after the step.  -> the card's model
    and optimizer state."""
    cfg = get_config(ARCH).replace(n_layers=2, dtype="float32")
    gpu, cpu = _card_and_cpu(cfg)
    opt = AdamW(lr=PARITY_LR)
    step = make_train_step(opt, total_steps=10, warmup=1)
    out = {}
    _zero_counters()
    for tag, model in (("card", gpu), ("cpu", cpu)):
        state = opt.init(dict(model.named_parameters()))
        batch = _lm_batch(cfg, 2, 64, model.device)
        t0 = time.perf_counter()
        state, m = step(model, state, batch)
        m = {k: float(v) for k, v in m.items()}
        out[tag] = (state, m, (time.perf_counter() - t0) * 1e3)
    launches = _no_kernel_launched("train_parity")
    (sg, mg, ms_g), (sc, mc, ms_c) = out["card"], out["cpu"]
    pg, pc = convert.lm_to_flat(gpu), convert.lm_to_flat(cpu)
    gm, cm = convert.lm_flat(cfg, sg.m), convert.lm_flat(cfg, sc.m)
    grad_err = max(((gm[k].cpu() - cm[k]).abs().max()
                    / cm[k].abs().max()).item() for k in cm)
    param_err, step_err, near_zero = 0.0, 0.0, 0
    for k in pc:
        err = (pg[k].cpu() - pc[k]).abs()
        well = cm[k].abs() >= TRAIN_WELL_M
        param_err = max(param_err, err[well].max().item()
                        if well.any() else 0.0)
        step_err = max(step_err, err.max().item())
        near_zero += int((~well).sum())
    rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30)
           for k in ("loss", "total", "grad_norm")}
    emit(phase="train_parity", arch=ARCH, layers=2, dtype="float32",
         batch=[2, 64], lr=PARITY_LR, card=mg, cpu=mc, rel_err=rel,
         aux_err=abs(mg["aux"] - mc["aux"]),
         grad_err_of_leaf_max=grad_err, param_max_abs_err=param_err,
         near_zero_grad_elements=near_zero,
         near_zero_grad_param_max_abs_err=step_err,
         step_ms_card=ms_g, step_ms_cpu=ms_c, launches=launches,
         tol=dict(loss=TRAIN_LOSS_RTOL, grad_norm=TRAIN_NORM_RTOL,
                  grad=TRAIN_GRAD_RTOL, param=TRAIN_PARAM_TOL,
                  near_zero_grad_param=TRAIN_BOUNDED_STEP))
    fail_unless(rel["loss"] <= TRAIN_LOSS_RTOL
                and rel["total"] <= TRAIN_LOSS_RTOL
                and abs(mg["aux"] - mc["aux"]) <= TRAIN_LOSS_RTOL
                and rel["grad_norm"] <= TRAIN_NORM_RTOL
                and mg["lr_scale"] == mc["lr_scale"]
                and sg.count == sc.count == 1,
                f"train_parity: metrics differ: {rel}")
    fail_unless(grad_err <= TRAIN_GRAD_RTOL and param_err <= TRAIN_PARAM_TOL
                and step_err <= TRAIN_BOUNDED_STEP,
                f"train_parity: gradients {grad_err} / params {param_err}, "
                f"{step_err} near a zero gradient")
    del cpu, sc
    return gpu, sg


def phase_train_lm() -> None:
    """The launcher at published width: stablelm-3b, 20 steps of 8 x 512
    tokens, remat ``full``, bf16; every loss finite and the last below
    the first, the peak memory under the card's, no kernel launched;
    step ms, tokens/s, MFU and peak GB beside the memory the weights,
    gradients and moments take."""
    args = train_launch.parser().parse_args(TRAIN_LM_ARGS)
    _zero_counters()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as runs:
        args.runs = runs
        out = train_launch.train(args)
    wall = time.perf_counter() - t0
    launches = _no_kernel_launched("train_lm")
    perf, losses = out["perf"], out["losses"]
    total = torch.cuda.get_device_properties(0).total_memory
    n = perf["n_params"]
    emit(phase="train_lm", args=TRAIN_LM_ARGS,
         losses=losses, step_ms_median=perf["step_ms_median"],
         first_step_ms=perf["first_step_ms"], step_ms=perf["step_ms"],
         tokens_per_s=perf["tokens_per_s"], mfu=perf["mfu"],
         mfu_peak_flops=perf["mfu_peak_flops"], n_params=n,
         n_active_params=perf["n_active_params"],
         mfu_every_param=6 * n * perf["tokens_per_step"]
         / (perf["step_ms_median"] / 1e3) / perf["mfu_peak_flops"],
         peak_gb=perf["peak_mem_bytes"] / 1e9, card_gb=total / 1e9,
         weights_grads_moments_gb=12 * n / 1e9,
         functional_update_reckoned_gb=26 * n / 1e9,
         card=perf["card"], energy_j=out["result"]["energy_j"],
         seconds=wall, launches=launches)
    fail_unless(all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0],
                f"train_lm: losses {losses}")
    fail_unless(perf["peak_mem_bytes"] < total,
                f"train_lm: peak {perf['peak_mem_bytes']} of {total}")


def phase_train_breakdown(peaks: dict) -> None:
    """Where a full-width train step's time goes: stablelm-3b, bf16,
    remat ``full``, 8 x 512 tokens, the launcher's step cut into the
    forward (the loss), the backward (with each layer's forward
    recomputed) and the in-place AdamW update, each timed to a
    synchronise, the median of 3 steps after a first; the profiler's
    products and the rest over one step; beside 6 N and 8 N FLOPs (8 N
    with the recompute) at the bf16 peak and the update's bytes."""
    cfg = get_config(ARCH)
    model = tfm.init_lm(cfg, 0, device="cuda")
    params = dict(model.named_parameters())
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    batch = _lm_batch(cfg, 8, 512, "cuda")
    tokens = batch["tokens"]
    parts = {"forward": [], "backward": [], "optimizer": []}

    def one_step(record=True):
        nonlocal state
        for p in params.values():
            p.requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, _ = lm_loss(model, tokens)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for p in params.values():
            p.requires_grad_(False)
        state, _ = opt.update_(dict(zip(params, grads)), state, params)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if record:
            for k, a, b in (("forward", t0, t1), ("backward", t1, t2),
                            ("optimizer", t2, t3)):
                parts[k].append((b - a) * 1e3)

    torch.cuda.reset_peak_memory_stats()
    one_step(record=False)
    for _ in range(3):
        one_step()
    peak = torch.cuda.max_memory_allocated()
    try:
        prof = _profile_step(lambda: one_step(record=False),
                             attention="flash_attention")
    except Exception as e:          # the profiler is untried on the card
        prof = {"error": repr(e)[:200]}
    n = sum(p.numel() for p in params.values())
    ntok = tokens.shape[0] * (tokens.shape[1] - 1)
    med = {k: float(np.median(v)) for k, v in parts.items()}
    step_ms = sum(med.values())
    emit(phase="train_breakdown", arch=ARCH, batch=[8, 512],
         remat=cfg.remat_policy, ms=med, step_ms=step_ms, all_ms=parts,
         bound_6n_ms=6 * n * ntok / peaks["bf16"] * 1e3,
         bound_8n_ms=8 * n * ntok / peaks["bf16"] * 1e3,
         optimizer_bytes=n * (2 + 2 + 16),
         optimizer_bound_ms=n * (2 + 2 + 16) / peaks["hbm"] * 1e3,
         peak_gb=peak / 1e9, profiler=prof)
    del model, params, state
    torch.cuda.empty_cache()


def phase_train_families():
    """Every other family at published width, depth 2 (recurrentgemma 3,
    to hold its windowed-attention layer; whisper's encoder 2 too),
    bf16, 3 steps on one batch of 2 x 256 tokens (mamba2's chunk of 256
    whole): the loss falls, the grad norm (so every gradient) and every
    parameter finite, no kernel launched; granite's aux positive;
    whisper's encoder and paligemma's prefix path given nonzero
    gradients.  -> whisper's model and optimizer state."""
    kept = None
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).replace(
            n_layers=3 if arch == HYBRID_ARCH else 2)
        if cfg.family == "encdec":
            cfg = cfg.replace(n_enc_layers=2)
        model = tfm.init_lm(cfg, 0, device="cuda")
        opt = AdamW(lr=3e-4)
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(opt, total_steps=3, warmup=1)
        batch = _lm_batch(cfg, 2, 256, "cuda")
        _zero_counters()
        ms, metrics = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            state, m = step(model, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = _no_kernel_launched(f"train_families {arch}")
        losses = [m["loss"] for m in metrics]
        finite = all(torch.isfinite(p).all().item()
                     for p in model.parameters())
        extra = {}
        if cfg.family == "encdec":
            extra["encoder_grad_max"] = max(
                t.abs().max().item() for k, t in state.m.items()
                if k.startswith("encoder."))
        if cfg.family == "vlm":
            pre = batch["prefix_embeds"].clone().requires_grad_(True)
            with torch.enable_grad():
                loss, _ = lm_loss(model, batch["tokens"], prefix_embeds=pre)
                (g,) = torch.autograd.grad(loss, pre)
            extra["prefix_grad_norm"] = g.float().norm().item()
        emit(phase="train_families", arch=arch, layers=cfg.n_layers,
             kinds=sorted(set(cfg.block_kinds)), dtype=cfg.dtype,
             batch=[2, 256], ssm_chunk=cfg.ssm_chunk if arch == SSM_ARCH
             else None, losses=losses,
             grad_norms=[m["grad_norm"] for m in metrics],
             aux=[m["aux"] for m in metrics], step_ms=ms,
             params_finite=finite, launches=launches, **extra)
        fail_unless(losses[-1] < losses[0]
                    and all(math.isfinite(m["grad_norm"]) for m in metrics)
                    and finite, f"train_families {arch}: {metrics}")
        fail_unless(all(m["aux"] > 0 for m in metrics) == cfg.is_moe,
                    f"train_families {arch}: aux {metrics}")
        fail_unless(all(v > 0 for v in extra.values()),
                    f"train_families {arch}: {extra}")
        if cfg.family == "encdec":
            kept = (model, state)
        del model, state
        torch.cuda.empty_cache()
    return kept


def phase_checkpoint(trained: dict) -> None:
    """Each (model, optimizer state) saved in the reference's layout and
    loaded into a fresh, uninitialised model and new moments on the
    card: every parameter, moment and the count equal byte for byte in
    their own dtypes."""
    for tag, (model, state) in trained.items():
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "ck.npz")
            t0 = time.perf_counter()
            checkpoint.save(path, {"params": model, "opt": state},
                            metadata={"arch": model.cfg.arch_id})
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            fresh = tfm.LM(model.cfg, device="cuda")
            back = checkpoint.load_into(path, {
                "params": fresh,
                "opt": AdamW().init(dict(fresh.named_parameters()))})
            load_s = time.perf_counter() - t0 - save_s
        st = back["opt"]
        equal = (all(torch.equal(a, b) and a.dtype == b.dtype
                     for a, b in zip(model.state_dict().values(),
                                     fresh.state_dict().values()))
                 and all(torch.equal(state.m[k], st.m[k])
                         and torch.equal(state.v[k], st.v[k])
                         for k in state.m)
                 and st.count == state.count)
        emit(phase="checkpoint", model=tag, arch=model.cfg.arch_id,
             dtypes=sorted({str(t.dtype) for t in model.parameters()}),
             bytes=size, save_s=save_s, load_s=load_s, count=st.count,
             equal=equal)
        fail_unless(equal, f"checkpoint {tag}: not byte-equal")
        del fresh, back


def phase_quant(smi: str) -> None:
    """stablelm-3b at published width, bf16, seeded: int8 through
    ``quantize_tree`` on the reference's stacked layout, dequantised to
    bf16 into a second model; one decode step after a 16-token prefill
    at 8 rows against the bf16 model's: the largest logit error under
    0.15 of the largest logit and top-1 agreement on half the rows or
    more (``tests/test_quant.py``'s bounds); the int8 tree's bytes
    against bf16's."""
    cfg = get_config(ARCH)
    model = tfm.init_lm(cfg, 0, device="cuda")
    t0 = time.perf_counter()
    qtree = quant.quantize_tree(convert.lm_to_flat(model))
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    chosen = sorted(k for k, v in qtree.items() if isinstance(v, dict))
    q_bytes = sum(t.numel() * t.element_size() for v in qtree.values()
                  for t in (v.values() if isinstance(v, dict) else [v]))
    qmodel = tfm.LM(cfg, device="cuda")
    quant.load_dequantized(qmodel, qtree, torch.bfloat16)
    del qtree
    B = 8
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (B, 17))

    def decode(m):
        cache = tfm.init_cache(cfg, B, 32, device="cuda")
        m.prefill(prompts[:, :16], cache)
        return m.decode_step(prompts[:, 16:17], cache, 16)[0][:, 0].float()

    ref, out = decode(model), decode(qmodel)
    rel = ((out - ref).abs().max() / (ref.abs().max() + 1e-9)).item()
    agree = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
    report = quant.quantization_error(convert.lm_to_flat(model))
    emit(phase="quant", arch=ARCH, nvidia_smi=smi, quantized=chosen,
         int8_tree_bytes=q_bytes, bf16_bytes=_weight_bytes(model),
         ratio=q_bytes / _weight_bytes(model), quantize_s=q_s,
         rows=B, max_rel_logit_err=rel, top1_agree=agree,
         max_leaf_rel_err=max(report.values(), default=None))
    fail_unless(bool(chosen) and chosen == sorted(report),
                f"quant: chose {chosen}")
    fail_unless(rel < 0.15 and agree >= 0.5,
                f"quant: logits {rel} of the largest, agreement {agree}")
    del model, qmodel
    torch.cuda.empty_cache()


def phase_train(smi: str, peaks: dict) -> None:
    """The training phases, in order: train_parity, train_lm,
    train_breakdown, train_families, checkpoint, quant."""
    parity = phase_train_parity()
    phase_train_lm()
    phase_train_breakdown(peaks)
    whisper = phase_train_families()
    phase_checkpoint({"stablelm_f32": parity, "whisper_bf16": whisper})
    del parity, whisper
    torch.cuda.empty_cache()
    phase_quant(smi)


class _ShapeMesh:
    """A mesh's axis sizes without a process group (the specs read only
    ``.shape`` and ``.axis_names``)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def phase_shard_specs() -> None:
    """The parameter specs of stablelm-3b, granite and llama3-405b at
    published width on 16 x 16, with and without fsdp (meta models, on
    the host): how many leaves shard over "model" and over "data"."""
    mesh = _ShapeMesh(data=16, model=16)
    rows = {}
    for arch in (ARCH, "granite-moe-3b-a800m", "llama3-405b"):
        cfg = get_config(arch)
        flat = convert.lm_flat(cfg, dict(tfm.abstract_lm(cfg)
                                         .named_parameters()))
        for fsdp in (False, True):
            specs = shd.param_specs(flat, mesh, cfg=cfg, fsdp=fsdp)
            rows[f"{arch}{'+fsdp' if fsdp else ''}"] = {
                "leaves": len(specs),
                "model_sharded": sum("model" in s for s in specs.values()),
                "data_sharded": sum("data" in s for s in specs.values())}
    fail_unless(all(r["model_sharded"] > 0 for r in rows.values()),
                f"shard_specs: every model shards some leaf over model: "
                f"{rows}")
    fail_unless(all(r["data_sharded"] > 0 for k, r in rows.items()
                    if k.endswith("+fsdp")),
                f"shard_specs: fsdp shards some leaf over data: {rows}")
    emit(phase="shard_specs", mesh="16x16", specs=rows)


def _greedy_steps(model, prompts, n_new, mesh=None):
    """A prefill then ``n_new`` greedy ``decode_step``s over a bf16
    cache of 128 rows, uncaptured; under ``sharded(mesh)`` on DTensors
    when ``mesh`` is given.  -> (tokens [B, n_new], the logits each was
    chosen from [B, n_new, V] in f32, ms per decode step, the sharded
    context's counts of the ops that gave up a shard or None)."""
    B, S = prompts.shape
    cache = tfm.init_cache(model.cfg, B, 128, device="cuda")
    ctx = contextlib.nullcontext()
    if mesh is not None:
        shd.distribute_cache(cache, mesh, shd.cache_specs(model.cfg, cache,
                                                          mesh, B))
        ctx = shd.sharded(mesh)

    def batch(t, key):
        return t if mesh is None else shd.distribute_batch({key: t},
                                                           mesh)[key]

    toks, seen = [], []
    with ctx as reshard:
        logits, cache = model.prefill(batch(prompts, "tokens"), cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_new):
            last = shd.full(logits)[:, -1]
            tok = last.argmax(-1)[:, None]
            toks.append(tok[:, 0])
            seen.append(last.float())
            logits, cache = model.decode_step(batch(tok, "token"), cache,
                                              S + i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_new * 1e3
    return (torch.stack(toks, 1), torch.stack(seen, 1), ms,
            reshard and reshard.counts())


def phase_serve_sharded() -> dict:
    """stablelm-3b at published width, bf16, seed 0, on a one-rank NCCL
    group and a 1 x 1 (data, model) mesh on the card: 8 slots over 128
    rows, a 16-token prefill and 16 greedy decode steps under
    ``sharded(mesh)`` on DTensor parameters, cache and tokens, held
    against the same steps without the mesh (tokens byte-equal, logits
    within ``ATTN_BF16_ROW_TOL`` of each row's largest); the hand
    kernels launch on the sharded path; the uncaptured ms per decode
    step both ways.  -> the sharded run's kernel launches."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(data=1, model=1)
        cfg = get_config(ARCH)
        model = tfm.init_lm(cfg, 0, device="cuda")
        gen = torch.Generator().manual_seed(5)
        prompts = torch.randint(0, cfg.vocab, (8, 16), generator=gen).cuda()
        want_toks, want_logits, plain_ms, _ = _greedy_steps(model, prompts,
                                                            16)
        flat = convert.lm_flat(cfg, dict(model.named_parameters()))
        shd.distribute_lm(model, mesh, shd.param_specs(flat, mesh, cfg=cfg))
        _zero_counters()
        toks, logits, sharded_ms, resharded = _greedy_steps(
            model, prompts, 16, mesh)
        launches = _attention_launches()
        err = row_scaled_error(logits, want_logits)
        emit(phase="serve_sharded", arch=ARCH, mesh=[1, 1], slots=8,
             rows=128, prompt=16, new_tokens=16,
             tokens_equal=bool(torch.equal(toks, want_toks)),
             logits_row_scaled_err=err, tol=ATTN_BF16_ROW_TOL,
             decode_ms_per_step_sharded=sharded_ms,
             decode_ms_per_step_unsharded=plain_ms, launches=launches,
             resharded=resharded)
        fail_unless(torch.equal(toks, want_toks),
                    "serve_sharded: tokens equal to the unsharded steps")
        fail_unless(err <= ATTN_BF16_ROW_TOL,
                    f"serve_sharded: logits row-scaled error {err}")
        fail_unless(launches["flash_attention"] > 0
                    and launches["decode_attention"] > 0,
                    f"serve_sharded: both kernels launched: {launches}")
        del model, flat
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


def phase_dryrun(matrix: bool = False) -> None:
    """``launch.dryrun`` in a subprocess (the fake group of 256 ranks,
    no card): the stablelm-3b ``decode_32k`` line, and its record; with
    ``matrix``, every arch on both meshes too (one process an arch, all
    at once), and the ok / skip / fail counts.  A fail is printed with
    its error, not hidden, and does not stop the smoke; so is each ok
    line's list of ops run on gathered values, replicated."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as out:
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             ARCH, "--shape", "decode_32k", "--mesh", "single", "--out",
             out], env=env, capture_output=True, text=True, timeout=900)
        fail_unless(run.returncode == 0
                    and "done: 1 ok, 0 skip, 0 fail" in run.stdout,
                    f"dryrun: the {ARCH} decode_32k line: "
                    f"{run.stdout[-500:]} {run.stderr[-1500:]}")
        with open(os.path.join(out, f"{ARCH}__decode_32k__single.json")) as f:
            rec = json.load(f)
        emit(phase="dryrun", seconds=time.perf_counter() - t0, record=rec)
    if not matrix:
        return
    t0 = time.perf_counter()
    counts = {"ok": 0, "skip": 0, "fail": 0}
    fails, replicated = [], {}
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--mesh", "both", "--out", out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            for arch in ARCH_IDS]
        for p in procs:
            stdout, _ = p.communicate(timeout=1500)
            m = re.search(r"done: (\d+) ok, (\d+) skip, (\d+) fail", stdout)
            fail_unless(m is not None, f"dryrun matrix: {stdout[-500:]}")
            for k, v in zip(("ok", "skip", "fail"), m.groups()):
                counts[k] += int(v)
        steps = {}
        for name in sorted(os.listdir(out)):
            with open(os.path.join(out, name)) as f:
                rec = json.load(f)
            if rec["status"] == "fail":
                fails.append({"line": name[:-5], "error": rec["error"][:400],
                              "traceback": rec["traceback"][-1200:]})
            elif rec["status"] == "ok":
                steps[name[:-5]] = rec["step_s"]
                if rec["resharded"]["replicated_ops"]:
                    replicated[name[:-5]] = rec["resharded"]["replicated_ops"]
    emit(phase="dryrun_matrix", meshes=["single", "multipod"],
         seconds=time.perf_counter() - t0, step_s=steps, fails=fails,
         replicated_ops=replicated, **counts)


def kernel_entry(name, src, replaces, tpu_kernel, launches, max_err, main):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": launches, "max_abs_err": max_err,
            "max_err": max_err, "case": main["case"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_computes": main["library_computes"],
            "call_ms": main["call_ms"]}


def decode_graph_only() -> None:
    """``--decode-graph``: the device, build, ``sampling_keys`` and
    ``decode_graph`` phases alone, each engine at its smoke configuration
    and at full width: the quickest check of the captured window (about
    a minute)."""
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    phase_sampling_keys(get_config(ARCH).vocab)
    for full in (False, True):
        for arch in (ARCH, SSM_ARCH):
            cfg = (get_config if full else get_smoke_config)(arch)
            model = tfm.init_lm(cfg, 0, device="cuda")
            tag = arch + ("" if full else "-smoke")
            phase_decode_graph(tag, cfg, model)
            if arch == ARCH:
                phase_decode_graph(f"{tag}-paged",
                                   cfg.replace(kv_block_size=PAGED_BS), model)
            del model
            torch.cuda.empty_cache()
    emit(phase="decode_graph_only", seconds=time.perf_counter() - t0)


def fleet_only() -> None:
    """``--fleet``: the device, build, train_classifier and fleet phases
    alone: the quickest check of the fleet layer on the card."""
    t0 = time.perf_counter()
    _, smi, idle = phase_device()
    phase_build()
    phase_fleet(phase_train_classifier(), smi, idle)
    emit(phase="fleet_only", seconds=time.perf_counter() - t0)


def disagg_only() -> None:
    """``--disagg``: the device, build and disagg phases alone, on the
    served model (stablelm-3b, full width, bf16, seed 0): the quickest
    check of the split-phase path on the card."""
    t0 = time.perf_counter()
    _, smi, _ = phase_device()
    phase_build()
    lm = tfm.init_lm(get_config(ARCH), 0, device="cuda")
    launches = phase_disagg(lm, smi)
    emit(phase="disagg_only", launches_by_path=launches,
         seconds=time.perf_counter() - t0)


def train_only() -> None:
    """``--train``: the device, build and training phases alone: the
    quickest check of LM training on the card."""
    t0 = time.perf_counter()
    name, smi, _ = phase_device()
    phase_build()
    phase_train(smi, PEAKS["pcie" if "pcie" in name.lower() else "sxm"])
    emit(phase="train_only", seconds=time.perf_counter() - t0)


def shard_only() -> None:
    """``--shard``: the device, build and sharding phases alone
    (``shard_specs``, ``serve_sharded``, ``dryrun`` with the whole
    matrix): the quickest check of the sharded path on the card."""
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    phase_shard_specs()
    launches = phase_serve_sharded()
    phase_dryrun(matrix=True)
    emit(phase="shard_only", launches_by_path={"serve_sharded": launches},
         seconds=time.perf_counter() - t0)


def latent_only() -> None:
    """``--latent``: the device, build, ``latent_decode`` and the MLA
    family's phases (``phase_mla_family``): the quickest check of the
    latent decode kernel on the card."""
    t0 = time.perf_counter()
    name, _, _ = phase_device()
    peaks = PEAKS["pcie" if "pcie" in name.lower() else "sxm"]
    phase_build()
    phase_latent_decode(peaks)
    launches = phase_mla_family(peaks)
    emit(phase="latent_only", launches_by_path=launches,
         seconds=time.perf_counter() - t0)


def attention_only() -> None:
    """``--attention``: the device, build, attention (every case and
    ``decode_invariance``), ``spec_chunk`` and the hd-256 families'
    phases (``phase_new_families``): the quickest check of the attention
    kernels on the card."""
    t0 = time.perf_counter()
    name, _, _ = phase_device()
    peaks = PEAKS["pcie" if "pcie" in name.lower() else "sxm"]
    phase_build()
    phase_attention(peaks)
    phase_spec_chunk(peaks)
    launches = phase_new_families(peaks)
    emit(phase="attention_only", launches_by_path=launches,
         seconds=time.perf_counter() - t0)


ONLY = {"--decode-graph": decode_graph_only, "--fleet": fleet_only,
        "--disagg": disagg_only, "--train": train_only,
        "--shard": shard_only, "--attention": attention_only,
        "--latent": latent_only}


def main(argv: list[str]) -> int:
    if argv and (len(argv) > 1 or argv[0] not in ONLY):
        print(f"usage: chip_smoke.py [--decode-graph | --fleet | --disagg | "
              f"--train | --shard | --attention | --latent], "
              f"got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if argv:
        ONLY[argv[0]]()
        return 0
    name, smi, idle = phase_device()
    peaks = PEAKS["pcie" if "pcie" in name.lower() else "sxm"]
    phase_build()
    max_err, main_row, ent_schedules, floor_ms = phase_kernel(peaks)
    trained = phase_train_classifier()
    launches = phase_serve()
    phase_system(*trained)
    fleet = phase_fleet(trained, smi, idle)
    launches["fleet"] = sum(fleet.values())
    del trained
    phase_resnet(smi)
    cfg, model, x = _gated_batch()
    phase_parity(cfg, model, x)
    phase_breakdown(cfg, model, x, peaks)
    del model, x
    attn = phase_attention(peaks)
    phase_latent_decode(peaks)
    spec_err, spec_main = phase_spec_chunk(peaks)
    phase_sampling_keys(get_config(ARCH).vocab)
    phase_serve_generate_smoke()
    gen_launches, lm = phase_serve_generate()
    phase_parity_generate(lm)
    phase_breakdown_generate(lm, peaks)
    phase_prefill_long_generate(lm)
    paged_launches = phase_serve_generate_paged()
    phase_parity_paged(lm)
    phase_decode_graph(ARCH, lm.cfg, lm)
    phase_decode_graph(f"{ARCH}-paged", lm.cfg.replace(kv_block_size=PAGED_BS),
                       lm)
    phase_parity_spec(lm)
    phase_decode_graph_spec(lm)
    disagg = phase_disagg(lm, smi)
    del lm
    torch.cuda.empty_cache()
    spec_launches = phase_serve_generate_spec()
    phase_serve_generate_sampled()
    ssd = phase_ssd(peaks)
    ssd_launches, ssm = phase_serve_generate_ssm()
    phase_parity_generate_ssm(ssm)
    phase_breakdown_generate_ssm(ssm, peaks)
    phase_decode_graph(SSM_ARCH, ssm.cfg, ssm)
    del ssm
    torch.cuda.empty_cache()
    fam = phase_families(peaks)
    new = phase_new_families(peaks)
    phase_train(smi, peaks)
    phase_shard_specs()
    sharded = phase_serve_sharded()
    phase_dryrun()
    moe, moe_paged = fam["serve_generate_moe"], fam["serve_generate_moe_paged"]
    by_path = {
        "flash_attention": {
            "serve_generate": gen_launches["flash_attention"],
            **{k: v["flash_attention"] for k, v in disagg.items()},
            "serve_generate_moe": moe["flash_attention"],
            "serve_generate_moe_paged": moe_paged["flash_attention"],
            **{k: new[k]["flash_attention"] for k in new},
            "serve_sharded": sharded["flash_attention"]},
        "decode_attention": {
            "serve_generate": gen_launches["decode_attention"],
            "serve_disagg": disagg["serve_disagg"]["decode_attention"],
            "fleet_generate": disagg["fleet_generate"]["decode_attention"],
            "serve_generate_moe": moe["decode_attention"],
            **{k: new[k]["decode_attention"] for k in new
               if k != "serve_generate_vlm_paged"},
            "serve_sharded": sharded["decode_attention"]},
        "paged_decode_attention": {
            "serve_generate_paged": paged_launches,
            "serve_disagg_paged": disagg["serve_disagg_paged"][
                "paged_decode_attention"],
            "serve_generate_moe_paged": moe_paged["paged_decode_attention"],
            "serve_generate_vlm_paged": new["serve_generate_vlm_paged"][
                "paged_decode_attention"]},
        "decode_attention_chunk": {
            "serve_generate_spec": spec_launches["decode_attention_chunk"],
            "serve_generate_vlm_spec": new["serve_generate_vlm_spec"][
                "decode_attention_chunk"]},
    }

    def attention_entry(name, src_line, tpu, extra=None):
        """An attention kernel's line: the stablelm main case's numbers,
        granite's G = 3 case beside them, launches summed over this
        kernel's main paths."""
        g3 = attn[name]["granite"]
        return dict(kernel_entry(
            name, "decode_attention.cu" if "decode" in name
            else "flash_attention.cu", src_line, tpu,
            sum(by_path[name].values()), attn[name]["max_err"],
            attn[name]["main"]), launches_by_path=by_path[name],
            g3={k: g3[k] for k in ("case", "H", "K", "hd", "ms", "call_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "max_abs_err",
                                   "row_scaled_err")},
            new_shapes=attn[name].get("new_shapes", {}), **(extra or {}))

    entropy = {
        "name": "entropy_stats",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/entropy.cu",
        "replaces": "src/repro/kernels/entropy.py:29",
        "tpu_kernel": "src/repro/kernels/entropy.py:_entropy_kernel",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max_err,
        "max_err": max_err,
        "shape": main_row["shape"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_computes": main_row["library_computes"],
        "call_ms": main_row["call_ms"],
        "plain_call_ms": main_row["plain_call_ms"],
        "library_call_ms": main_row["library_call_ms"],
        "launch_floor_ms": floor_ms,
        "schedules": ent_schedules,
    }
    emit(kernels=[
        entropy,
        attention_entry("flash_attention",
                        "src/repro/kernels/flash_attention.py:26",
                        "src/repro/kernels/flash_attention.py:_flash_kernel"),
        attention_entry("decode_attention",
                        "src/repro/kernels/decode_attention.py:45",
                        "src/repro/kernels/decode_attention.py:"
                        "_decode_kernel"),
        attention_entry(
            "paged_decode_attention",
            "src/repro/kernels/decode_attention.py:167",
            "src/repro/kernels/decode_attention.py:_paged_kernel",
            dict(shim_ms=attn["paged_decode_attention"]["main"]["shim_ms"],
                 oracle="paged_decode_attention_shim (src/repro/kernels/"
                        "decode_attention.py:291): gather + "
                        "decode_attention, torch.equal in every paged "
                        "case")),
        dict(kernel_entry(
            "decode_attention_chunk", "decode_attention.cu",
            "src/repro/models/attention.py:446",
            None, sum(by_path["decode_attention_chunk"].values()), spec_err,
            spec_main),
            launches_by_path=by_path["decode_attention_chunk"],
            note="the port's own entry on #2's body: no TPU kernel, the "
                 "reference attends the verify chunk in einsum "
                 "(chunk_attend)",
            single_query_launches_ms=spec_main["single_query_launches_ms"]),
        dict(kernel_entry("ssd_scan", "ssd_scan.cu",
                          "src/repro/kernels/ssd_scan.py:31",
                          "src/repro/kernels/ssd_scan.py:_ssd_kernel",
                          ssd_launches, ssd["max_err"], ssd["main"]),
             max_rel_err=ssd["max_rel_err"],
             entries="ssd_scan (zero state, y) and ssd_chunked (h0 -> y, "
                     "h_last); the serving prefill runs ssd_chunked",
             schedules="one chunk, one launch, for S <= 64 (the serving "
                       "prefill); chunk-parallel, three launches with "
                       "3xTF32 mma.sync products, beyond"),
    ])
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
