#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the whole check, one NVIDIA GPU

Phases, one JSON line each:

1. device — needs ``torch.cuda.is_available()``; prints ``nvidia-smi``'s
   name and power limit of the card;
2. build — compiles the ``engine_step`` (the per-cycle ``engine_step``
   and the whole-run ``engine_run`` kernels), ``colibri_scatter``,
   ``flash_attention``, ``flash_attention_bwd``, ``rglru_scan``,
   ``rwkv6_wkv`` and ``grouped_matmul`` CUDA libraries from the
   checkout, one ``nvcc`` each, in parallel, and reports each kernel's
   ``ptxas`` line;
3. kernel — the engine_step kernel against its plain PyTorch version on
   the card, for each of the eleven protocols (colibri_hier at 1, 3 and
   4 groups: ``PROTO_CASES``) at every (cores, banks) shape the later
   phases run, plus the reference's multi-tile case, over chained cycles
   from seeded random states (the lock bits, the ticket dispensers, the
   cores' held tickets, nb_feb's full/empty bits apart from its queue
   lengths, and the two-level queues in the shape the protocols reach,
   ``random_hier_bank``): every output, bank array and per-core write
   must be equal;
   model_check — the model checker's full gate
   (``repro_torch.analysis.model_check``: all eleven protocols, every
   configuration, the kill pass) with the engine_step kernel as the
   fused twin: each distinct delivery one launch of the one-candidate
   step, its bank state, kind and per-core writes held to ``on_access``
   under every rule; 0 findings, states and transitions equal to the
   same gate with ``fused_access`` on the CPU; its launches and
   seconds;
   run_kernel — the engine_run kernel (one launch per run) against the
   plain loop (``sim._simulate_plain``, one engine_step launch per
   cycle) on the card, for each ``PROTO_CASES`` entry at every such
   shape over ``RUN_KERNEL_CYCLES`` cycles (the protocols of earlier
   slices over ``RUN_KERNEL_CYCLES_EARLIER``), untraced and with
   ``record_trace`` and 64 telemetry windows, plus the colibri_workers
   point and, for each entry, one traced run with per-core state in
   device memory (more than 2 048 cores) and one with per-bank state in
   the scratch buffer (more banks than shared memory holds); then the
   workload programs on the kernel's program instance: ``ms_queue``,
   ``treiber_stack`` and ``barrier_phases`` (``PROGRAM_WORKLOADS``) for
   each of the eleven protocols at their scenario's banks and 256 cores,
   untraced and traced, the script's own program (``OWN_FIELDS``:
   per-step durations, a barrier mid-program) for each protocol, and
   ``barrier_phases`` with Fig. 5 workers; then the topology instance:
   every protocol on cluster2 and cluster3 at 256 cores with link budgets
   that turn crossing requests away, on the skewed Zipf stream in the
   sweep's form in turns, two more register layouts on cluster3 with
   Fig. 5 workers, and the Zipf cases (``ZIPF_KERNEL_CASES``: the
   threshold lookup in both forms, the log-uniform limit, the skew-0
   fused multiply-add at 43 bins); then the fault instance
   (``fault_params``): every protocol at 256 × 4 under one mixed plan
   (``FAULT_KERNEL_PLAN``: a holder kill, the watchdog, request and
   wakeup drops, a bank stall, the progress detector; the watchdog must
   recover and the detector flag a halt within the run), lrscwait and
   ticket_lock traced under a uniform kill and a stall window, and
   colibri_hier on cluster2, ms_queue for colibri and lrsc, and the two
   other layouts with a plan: every key of the result dict equal,
   traces, ``hops`` and the fault keys included;
4. scatter_kernel — the colibri_scatter kernel against its plain
   version on the card at the reference tests' shapes (f32 and bf16),
   the trace path's shapes and two large ones, on uniform keys and with
   keys dropped at both ends (equal to ``bins``, and negative), then on
   a skewed 2^20-key stream (Zipf, exponent 2, 64 bins), one key over
   2^20 rows and T = 0: float sums within ``tests/test_kernels.py``'s
   tolerances, histograms exact (also against ``torch.bincount``), two
   calls bit for bit;
5. the LM serve paths, recurrentgemma-2b, rwkv6-1.6b, kimi-k2-1t-a32b's
   MoE layer, deepseek-v3-671b, whisper-large-v3 and phi-3-vision-4.2b:
   flash_kernel / rglru_kernel — each kernel against its plain version
   on the card at the reference tests' shapes and the serve shapes
   (flash: also whisper's non-causal encoder over 1 500 frames and its
   cross-attention, 128 positions against them, and head dim 96),
   within ``FLASH_TOL`` / ``RGLRU_TOL`` (flash: bf16 through the
   tensor-core design, f32 through the CUDA-core one, and one request
   alone gives the same bits as in its batch; rglru: also at its tile
   edges, on contiguous inputs and on the model's strided views, h with
   a's strides);
   serve_a — full width, one (rglru, rglru, local) unit, f32 weights
   seeded on the card and copied to the CPU: the card's prefill and
   decode logits, teacher-forced on the CPU engine's greedy tokens,
   within ``SERVE_A_TOL`` of the port's CPU logits;
   serve_b — a main path: full width and depth, bf16, four
   512-token requests and 16 new tokens each through ``ServeEngine``;
   exactly 8 flash_attention and 18 rglru_scan launches in the
   prefill and none in decode, finite logits, prefill ms, decode ms
   per token, peak memory, a profile of one prefill and one decode
   step;
   rwkv_kernel — the rwkv6_wkv kernel against its plain version on the
   card, ``out`` and the final state, at the reference tests' shapes,
   the serve shapes, a 4 096-step one and its edges (T = 1, 63, 65),
   for four decay distributions, within ``RWKV_TOL``; rwkv_serve_a — full width, 2 layers, f32, card
   logits against the CPU's as serve_a; rwkv_serve_b — the newest main
   path, as serve_b: full width and depth (24 layers, bf16), four
   512-token requests and 16 new tokens each through ``ServeEngine``,
   exactly 24 rwkv6_wkv launches per prefill and none in decode;
   gmm_kernel — the grouped_matmul kernel against its plain version on
   the card at the reference tests' shapes and an odd one (f32, bf16)
   and the serve shapes (bf16; the plain f32 product a few experts at a
   time), within ``GMM_TOL`` (bf16 through the tensor-core design, f32
   through the CUDA-core one; a quarter of the slots computed alone give
   the same bits as in the full buffer); moe_serve_a — kimi-k2-1t-a32b
   at full width, 2 layers (dense, MoE), experts cut to 32, f32, card logits
   against the CPU's as serve_a, router picks that differ reported and
   each held to be a near-tie; moe_serve_b — the newest main path: full
   width with all 384 experts, 2 layers, bf16 (~40 GB of weights seeded
   in place on the card), four 512-token requests and 16 new tokens each
   through ``ServeEngine``: exactly 2 flash_attention and 3
   grouped_matmul launches per prefill and 3 grouped_matmul launches per
   decode step;
   flash_window — the flash kernel's window and MLA's head dims against
   the plain version within ``FLASH_TOL`` (``FLASH_WINDOW_SHAPES``, f32
   and bf16): long_serve_b's band (6 144 tokens, window 2 048), a window
   past the sequence (the causal kernel's bits), mla_serve_b's 192/128
   shape and a ragged one;
   mla_serve_a — deepseek-v3-671b at full width, 2 layers (dense, MoE;
   the MoE layers start at 1), experts cut to 32, f32, card logits
   against the CPU's as moe_serve_a; mla_serve_b — a main path: full
   width with all 256 experts, depth cut to 4 (the three dense layers
   and the first MoE layer), bf16, four 512-token requests and 16 new
   tokens each: exactly 4 flash_attention (at 192/128) and 3
   grouped_matmul launches per prefill, 3 grouped_matmul per decode
   step;
   long_serve_a — recurrentgemma-2b, one (rglru, rglru, local) unit, f32,
   two 4 096-token prompts (twice the window), card against CPU as
   serve_a; long_serve_b — a main path: full width and depth, bf16, two
   6 144-token prompts, 16 new each: 8 windowed flash_attention and 18
   rglru_scan launches per prefill;
   whisper_serve_a — whisper-large-v3 at full width (d 1 280, 20 heads
   of 64, 1 500 frames), 2 encoder and 2 decoder layers, f32, seeded
   frame embeddings, 2 x 64 tokens: card logits against the CPU's as
   serve_a, the greedy picks and the engines' tokens equal, 6
   flash_attention launches per prefill; whisper_serve_b — a main path:
   full width and depth (32 + 32 layers, bf16), four 128-token requests
   and 16 new tokens each through ``ServeEngine`` (the reference
   engine's zero frame embeddings): exactly 96 flash_attention launches
   per prefill (each encoder layer's, each decoder layer's self- and
   cross-attention) and none in decode; phi_serve_a / phi_serve_b —
   phi-3-vision-4.2b likewise (d 3 072, 32 heads of 96): 2 layers, f32,
   256 seeded patch embeddings over 2 x 512 tokens, 2 launches per
   prefill; full depth (32 layers, bf16), four 512-token requests (text
   after the engine's 256 zero patches): 32 launches at head dim 96 per
   prefill, none in decode;
   lm_kernel_time — the four kernels' device time at the serve shapes
   beside their bounds, their plain versions and the library call
   (flash: ``scaled_dot_product_attention``, also at head dim 112, at
   the band (with a boolean band mask), at 192/128, at whisper's
   encoder and cross-attention shapes and at head dim 96;
   grouped_matmul: ``torch.bmm``);
5b. the training path, smollm-135m (the dense family):
   flash_bwd_kernel — the flash-attention backward kernels
   (``csrc/flash_attention_bwd.cu``, dq then dk/dv) against their plain
   version on the card, on the forward kernel's o and lse, at
   ``FLASH_BWD_SHAPES`` (smollm's heads at 1 024 tokens in f32 and bf16,
   a ragged non-causal hd-128 one, bf16 at hd 112 causal with GQA and at
   hd 32, train_b's own shape): the forward's
   o within ``FLASH_TOL`` and its lse within ``FLASH_LSE_TOL`` of the
   plain forward, dq, dk, dv within ``FLASH_BWD_TOL``, two
   launches bit for bit, the forward with lse bit for bit the forward
   without;
   train_a — full width (d 576, 9 heads on 3, hd 64, d_ff 1 536, vocab
   49 152, tied), 2 layers, f32, B 2 x 512 tokens: the loss, every
   gradient leaf and the parameters after 2 AdamW steps on the card
   against the port's CPU run from the same weights, within
   ``TRAIN_A_TOL``;
   train_b — the training main path: full width and depth (30 layers,
   bf16, remat, f32 moments) through ``launch.train.run_training``,
   4 096 tokens, the global batch cut from 256 to 8, AdamW at
   ``TRAIN_OPT``: 6 steps with a checkpoint every 3, then a run that
   crashes at step 4 and resumes, equal to the first bit for bit;
   exactly ``TRAIN_B_LAUNCHES`` every step, losses finite and falling, ms
   per step, tokens/s, the busy share of a profiled step, peak memory;
   train_kernel_time — the backward's device time per call and per
   launch (dq, dk/dv) at train_b's shape beside its bound (five products)
   and the kernels' own (seven), its plain version and the backward of
   ``scaled_dot_product_attention`` on the same tensors, timed alone;
   also the forward with lse beside ``scaled_dot_product_attention``'s
   forward; and (``FLASH_BWD_TIMED``) each newer instance at its training
   path's shape (the band with a boolean band mask for the library call),
   and the scan's gradient at rg_train_b's shape;
5c. the training paths of recurrentgemma-2b (local and rglru layers),
   whisper-large-v3 (the encoder-decoder) and phi-3-vision-4.2b (the
   VLM): flash_bwd_kernel also holds ``FLASH_BWD_NEW`` (hd 80 and 96 in
   both dtypes, whisper's encoder and cross-attention, recurrentgemma's
   band at 4 096 tokens and a ragged f32 band; the windowed forward with
   lse bit for bit the windowed forward without); rglru_bwd_kernel — the
   scan's gradient (one launch of ``csrc/rglru_scan.cu`` over the
   reversed time axis, ordered look-back) against ``rglru_scan_bwd_ref``
   at ``RGLRU_BWD_SHAPES`` on the model's views, two calls bit for bit;
   rg_train_a, whisper_train_a — full width, f32 (one ``rglru, rglru,
   local`` unit; 2 + 2 layers against 1 500 frames), card against the
   port's CPU run within ``TRAIN_A_TOL`` as train_a (recurrentgemma's
   parameters with ``RG_TRAIN_A["excused"]``: at most one element in a
   million of a leaf past the tolerance, at near-zero CPU gradients, each
   within ``adam_reach``); rg_train_b,
   whisper_train_b, phi_train_b — the training main paths at full width,
   bf16, remat, f32 moments through ``run_training``, 3 steps
   (``RG_TRAIN_B``, ``WHISPER_TRAIN_B``, ``PHI_TRAIN_B``: phi's depth cut
   to 28; AdamW at ``NEW_TRAIN_OPT``): exactly ``*_TRAIN_B_LAUNCHES``
   every step, losses finite and falling, ms per step, tokens/s, the
   busy share of the profiled last step, peak memory;
6. exact — ``zipf_index`` (skew 0, and the skewed streams of
   ``ZIPF_PROBES`` in either form) and ``_hash`` on the card against the
   CPU over 2^24 inputs, and the engine_run kernel's own device code
   (``_hash``, the backoff jitter, the uniform and skew-0 Zipf address of
   every 24-bit hash, at ``ZIPF_FMA_BINS`` too, and the threshold search
   of the ``ZIPF_PROBES`` streams) through the library's probe entry;
7. golden — ``repro_torch.sync.run`` on the card reproduces the
   reference's golden values (``tests/test_protocols.py``) for every
   protocol that has them (all but ``ticket_lock``, ``colibri_hier``,
   ``hw_event`` and ``nb_feb``), each point one engine_run launch and no
   engine_step launch, and one point per protocol equals the port's own
   CPU run key for key; ``colibri_hier``, ``hw_event`` and ``nb_feb`` at
   every golden configuration equal the port's CPU run on every integer
   key, without a poll, and the reference's three ``test_colibri_hier_*``
   invariants hold on the card;
8. main path — the paper's 256-core MemPool (Fig. 3 histogram, uniform
   bins) at the paper's 20 000 cycles for colibri and lrsc at 1 and 256
   bins, and a 1024-core colibri point: summaries and metrics equal the
   reference's values below, one engine_run launch per point;
9. trace path — the four 256-core points with ``record_trace`` and 64
   telemetry windows at 5 000 cycles: the traces, telemetry, exact-waits
   latency percentiles, ``trace_latency_hist`` (one colibri_scatter
   launch), span counts and, at one bin, the Perfetto JSON equal the
   reference's values below; colibri shows no BACKOFF span and no poll,
   lrsc shows BACKOFF spans; ms per cycle beside the same point
   untraced, and the run's byte bound; one engine_run launch per point;
10. profile — device time by kernel over a whole run of the 256-core
   colibri point (``torch.profiler``), untraced and traced: the card's
   busy share of the run's wall, engine_run's share of the busy time;
11. sweep — the batched sweep (``repro_torch.sync.Study`` → one launch
   of the engine_run kernel per core count, a grid of run blocks): the
   Fig. 3 uniform lines (``SWEEP_LINES`` × ``SWEEP_BINS``, 256 cores,
   ``FULL_WIDTH_CYCLES``; the skewed companion lines are fig3_skew's)
   and the 1024-core colibri point as one Study of 2 launches,
   then the mixed grid (``SWEEP_MIXED``: one launch whose blocks differ
   in every ``DYN_FIELDS`` field but ``zipf_skew``, banks padded to the
   bucket, the Fig. 5 workers, one traced point): every point bit for
   bit equal to its own single ``run`` (padded bank rows at the initial
   state), every ``Result.ok``, the full-width points equal to
   ``FULL_WIDTH_REF``; the Study's wall against the sum of its single
   runs' walls and its busy share (the chunks' card time from CUDA
   events over the wall; the profiler's reading beside it), ms per
   launch and per point for ``SWEEP_B`` seeds of colibri 256 × 1 (CUDA
   events) beside the barrier floor of a grid of as many blocks and the
   byte bound, and the blocks resident per SM with the registers and
   local (spill) bytes a thread of each instance of the kernel;
   fig4 — Fig. 4 (``benchmarks/bench_locks.py``): colibri and the four
   lock baselines × ``SWEEP_BINS``, 256 cores, ``FIG4_CYCLES``, the locks
   with the paper's fixed 128-cycle backoff, as one Study of ONE launch,
   every point bit for bit equal to its single run; the figure's rows
   (updates per cycle and Jain fairness per bin), the launch's card time
   against the 30 single runs, the busy share;
   hier — colibri and nb_feb, colibri_hier at 1, 2, 4, 8 and 16 groups
   and hw_event at 4 (``HIER_LINES``) × ``SWEEP_BINS``, 256 cores,
   ``HIER_CYCLES``, uniform bins, as one Study of ONE launch (48 blocks
   whose group counts differ), every point bit for bit equal to its
   single run and without a poll; updates per cycle and Jain fairness
   per point, the launch's card time, the Study's wall against its
   single runs', the busy share;
   hier_time — the three at 256 × 1, ``FULL_WIDTH_CYCLES``, beside
   colibri: µs per simulated cycle, and the registers, spill and blocks
   per SM of each instance of the kernel;
   fig6 — Fig. 6 (``benchmarks/bench_queue.py``): ``ms_queue`` at its
   scenario (head and tail words, ``modify`` 8), the paper's fixed
   128-cycle backoff, colibri, colibri_hier, lrsc and amo_lock × 2–256
   cores, ``FIG6_CYCLES``, as one Study of ONE launch per core count (6),
   every point bit for bit equal to its single run and passing
   ``Result.check()``; the figure's rows, ``bench_queue.headline``'s
   entries from them, card ms per launch, the Study's wall against its
   single runs', the busy share;
   workloads — the workload grid (``benchmarks/bench_workloads.py``):
   rmw_loop, ms_queue, treiber_stack, zipf_histogram (skew 1.0) and
   barrier_phases × its five protocols × 2 seeds, and its Zipf ladder
   (colibri and lrsc at skews 0, 1.0 and 2.0), at 64 cores as one Study
   of ONE launch, each point against its single run (a Study of the
   point alone where the sweep's stream differs) and ``Result.check()``;
   ops per cycle per row equal to the reference's, no poll for the
   polling-free ones, card ms, wall, busy share;
   program_time — colibri and lrsc on each program workload at 256
   cores, ``FULL_WIDTH_CYCLES``: µs per simulated cycle; the program
   instance's registers, spill and blocks per SM;
   fig3_skew — Fig. 3's skewed companion lines (colibri and lrsc at
   zipf_skew 150 × ``SWEEP_BINS``, 256 cores, ``FIG3_SKEW_CYCLES``) as
   one Study of ONE launch in the sweep's form of the stream (threshold
   tables in the launch's buffer), each point against its single run,
   the rows equal to the reference's (``FIG3_SKEW_REF``);
   topology — ``benchmarks/bench_topology.py``'s 17 points (colibri,
   lrsc, colibri_hier, hw_event, nb_feb on flat and cluster2 at 256 and
   1 024 cores, colibri_hier's flat → cluster2 → cluster3 ladder) as one
   Study of one launch per core count on the topology instance, each
   point against its single run, ``hops`` on the hierarchical ones only,
   the rows and the benchmark's headline equal to the reference's
   (``TOPO_REF``), three points against the plain loop on the card;
   topo_time — µs per simulated cycle of colibri 256 × 4 on flat (its
   own instance and the topology instance), cluster2 and cluster3, and
   of the Zipf lookup (colibri and lrsc at 256 × 1 024, skew 0 beside
   150); the topology instance's registers, spill and blocks per SM;
   faults — ``benchmarks/bench_faults.py``'s 38 fault points and the 9
   healthy runs it divides by (64 cores, ``FAULTS_CYCLES``) as one
   Study of ONE launch on the fault instance, each point against its
   single run; the rows and the headline (9 of 9 protocols live with
   the watchdog, 8 of 8 deadlocks detected without it) equal to
   ``reports/benchmarks.faults.json``; the launch's card time and busy
   share;
   fault_time — µs per simulated cycle of colibri and lrsc at 256 × 1
   under the benchmark's owner kill (the fault instance) beside the
   empty plan (their own instance, the topology instance and the fault
   instance); the fault instance's registers, spill and blocks per SM;
12. kernel times — engine_run's device time per run at the five
   main-path points beside its byte bound and the barrier-only floor of
   its chain of cycles, and the plain loop's time at the first, whose
   20 000-cycle result must equal the kernel's on every key; each
   protocol's 256 × 1 run (``lock_time``: the four locks beside
   colibri); each
   other kernel's device time per call (profiler) beside its bound, its
   plain version's and the PyTorch library call's, at the shapes the
   paths give it (colibri_scatter also on the trace phase's own four
   streams beside uniform keys of their length, on the skewed stream,
   and beside the launch floor: one elementwise add on one element);
   the kernels line.

The reference values below were computed with the JAX package
(``repro``); ``tests/test_torch_sync.py`` and
``tests/test_torch_trace_values.py`` recompute them so they cannot
drift.  The script imports neither JAX nor ``repro``.  It exits non-zero
when any phase fails, and its last line is the device record.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the training entry point's allocator setting (repro_torch.launch.train's
# CUDA_ALLOC_CONF, which its main sets): this script calls run_training
# in its own process, so it sets it before torch starts, for every phase
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.analysis import model_check  # noqa: E402
from repro_torch.analysis.report import fail_fast  # noqa: E402
from repro_torch.core import metrics, protocols, sim, workloads  # noqa: E402
from repro_torch.core.workloads.base import (  # noqa: E402
    ADDR_ZIPF, zipf_factors, zipf_index, zipf_thresholds)
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels import colibri_scatter, engine_step  # noqa: E402
import repro_torch.kernels.colibri_scatter.kernel as cs_kernel  # noqa: E402
from repro_torch.kernels.engine_step import kernel as es_kernel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention, rglru_scan  # noqa: E402
from repro_torch.kernels import grouped_matmul, rwkv6_wkv  # noqa: E402
import repro_torch.kernels.flash_attention.kernel as fa_kernel  # noqa: E402
import repro_torch.kernels.grouped_matmul.kernel as gm_kernel  # noqa: E402
import repro_torch.kernels.rglru_scan.kernel as rg_kernel  # noqa: E402
import repro_torch.kernels.rwkv6_wkv.kernel as rw_kernel  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.obs import perfetto  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Request, ServeEngine, frontend_inputs)
from repro_torch.obs.schema import STATE_NAMES  # noqa: E402
from repro_torch.faults import FaultPlan  # noqa: E402
from repro_torch.sync import Spec, run  # noqa: E402
from repro_torch import optim, tree  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
import repro_torch.launch.train as train_mod  # noqa: E402

PROTOS = ("amo", "lrsc", "lrscwait", "colibri", "amo_lock", "lrsc_lock",
          "ticket_lock", "mwait_lock", "colibri_hier", "hw_event", "nb_feb")
#: the two-level queues and nb_feb, the last protocols ported
HIER_PROTOS = ("colibri_hier", "hw_event", "nb_feb")
#: (protocol, n_groups) of the kernel and run_kernel phases: each
#: protocol at the default 4 groups, and colibri_hier also at 1 group and
#: at 3 (which do not divide the core counts: the last group is larger)
PROTO_CASES = tuple((pr, 4) for pr in PROTOS) + (("colibri_hier", 1),
                                                 ("colibri_hier", 3))

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12

# ---- the reference's golden values (tests/test_protocols.py) ----------
GOLDEN_CONFIGS = (
    dict(n_cores=64, n_addrs=1, cycles=3000, seed=1),
    dict(n_cores=64, n_addrs=16, cycles=3000, seed=2),
    dict(n_cores=128, n_addrs=4, cycles=2000, lat=3, work=6, modify=2,
         net_bw=32, seed=3),
)
GOLDEN = {
 "amo/0": {"ops": 2990, "msgs": 5990, "polls": 0, "sleep_cyc": 0,
           "backoff_cyc": 0, "bank_ops": 2995, "net_stall": 0,
           "ops_min": 46, "ops_max": 47},
 "amo/1": {"ops": 9596, "msgs": 19200, "polls": 0, "sleep_cyc": 0,
           "backoff_cyc": 0, "bank_ops": 9600, "net_stall": 0,
           "ops_min": 149, "ops_max": 150},
 "amo/2": {"ops": 7976, "msgs": 15976, "polls": 0, "sleep_cyc": 0,
           "backoff_cyc": 0, "bank_ops": 7988, "net_stall": 5,
           "ops_min": 62, "ops_max": 63},
 "lrsc/0": {"ops": 164, "msgs": 3004, "polls": 585, "sleep_cyc": 0,
            "backoff_cyc": 163358, "bank_ops": 1502, "net_stall": 0,
            "ops_min": 0, "ops_max": 16},
 "lrsc/1": {"ops": 1537, "msgs": 8384, "polls": 550, "sleep_cyc": 0,
            "backoff_cyc": 125958, "bank_ops": 4192, "net_stall": 0,
            "ops_min": 5, "ops_max": 41},
 "lrsc/2": {"ops": 531, "msgs": 5614, "polls": 868, "sleep_cyc": 0,
            "backoff_cyc": 224991, "bank_ops": 2807, "net_stall": 5,
            "ops_min": 0, "ops_max": 18},
 "lrscwait/0": {"ops": 226, "msgs": 1028, "polls": 0, "sleep_cyc": 183068,
                "backoff_cyc": 0, "bank_ops": 514, "net_stall": 0,
                "ops_min": 3, "ops_max": 4},
 "lrscwait/1": {"ops": 3621, "msgs": 14594, "polls": 0, "sleep_cyc": 85759,
                "backoff_cyc": 0, "bank_ops": 7297, "net_stall": 0,
                "ops_min": 55, "ops_max": 58},
 "lrscwait/2": {"ops": 1124, "msgs": 4736, "polls": 0, "sleep_cyc": 234432,
                "backoff_cyc": 0, "bank_ops": 2368, "net_stall": 5,
                "ops_min": 8, "ops_max": 9},
 "colibri/0": {"ops": 196, "msgs": 1818, "polls": 0, "sleep_cyc": 183939,
               "backoff_cyc": 0, "bank_ops": 455, "net_stall": 0,
               "ops_min": 3, "ops_max": 4},
 "colibri/1": {"ops": 3161, "msgs": 24720, "polls": 0, "sleep_cyc": 98536,
               "backoff_cyc": 0, "bank_ops": 6374, "net_stall": 0,
               "ops_min": 48, "ops_max": 51},
 "colibri/2": {"ops": 874, "msgs": 7488, "polls": 0, "sleep_cyc": 238668,
               "backoff_cyc": 0, "bank_ops": 1874, "net_stall": 19,
               "ops_min": 6, "ops_max": 7},
 "amo_lock/0": {"ops": 174, "msgs": 2732, "polls": 1017, "sleep_cyc": 0,
                "backoff_cyc": 172636, "bank_ops": 1366, "net_stall": 0,
                "ops_min": 0, "ops_max": 9},
 "amo_lock/1": {"ops": 1632, "msgs": 8076, "polls": 764, "sleep_cyc": 0,
                "backoff_cyc": 128388, "bank_ops": 4038, "net_stall": 0,
                "ops_min": 9, "ops_max": 56},
 "amo_lock/2": {"ops": 580, "msgs": 5062, "polls": 1367, "sleep_cyc": 0,
                "backoff_cyc": 233012, "bank_ops": 2531, "net_stall": 5,
                "ops_min": 0, "ops_max": 18},
 "lrsc_lock/0": {"ops": 121, "msgs": 4734, "polls": 1001, "sleep_cyc": 0,
                 "backoff_cyc": 169020, "bank_ops": 1244, "net_stall": 0,
                 "ops_min": 0, "ops_max": 9},
 "lrsc_lock/1": {"ops": 1239, "msgs": 10592, "polls": 780, "sleep_cyc": 0,
                 "backoff_cyc": 131471, "bank_ops": 3269, "net_stall": 0,
                 "ops_min": 3, "ops_max": 37},
 "lrsc_lock/2": {"ops": 451, "msgs": 8186, "polls": 1368, "sleep_cyc": 0,
                 "backoff_cyc": 230369, "bank_ops": 2272, "net_stall": 39,
                 "ops_min": 0, "ops_max": 17},
 "mwait_lock/0": {"ops": 196, "msgs": 1426, "polls": 0, "sleep_cyc": 183939,
                  "backoff_cyc": 0, "bank_ops": 455, "net_stall": 0,
                  "ops_min": 3, "ops_max": 4},
 "mwait_lock/1": {"ops": 3161, "msgs": 18760, "polls": 0,
                  "sleep_cyc": 98536, "backoff_cyc": 0, "bank_ops": 6374,
                  "net_stall": 0, "ops_min": 48, "ops_max": 51},
 "mwait_lock/2": {"ops": 874, "msgs": 5736, "polls": 0, "sleep_cyc": 238668,
                  "backoff_cyc": 0, "bank_ops": 1874, "net_stall": 19,
                  "ops_min": 6, "ops_max": 7},
}
#: the protocols with golden values (ticket_lock has none: the run_kernel
#: phase and the CPU parity tests hold it)
GOLDEN_PROTOS = tuple(pr for pr in PROTOS if f"{pr}/0" in GOLDEN)
GOLDEN_EXTRA = {
 "lrscwait_q8": (dict(n_cores=64, n_addrs=1, q_slots=8, cycles=3000, seed=4),
                 {"ops": 222, "msgs": 2024, "polls": 560, "sleep_cyc": 20630,
                  "backoff_cyc": 156604, "bank_ops": 1012, "net_stall": 0,
                  "ops_min": 0, "ops_max": 10}),
 "lrsc_workers": (dict(protocol="lrsc", n_cores=64, n_addrs=1, n_workers=8,
                       net_bw=13, hol_block=16, cycles=3000, backoff=128,
                       backoff_exp=1, seed=5),
                  {"ops": 169, "msgs": 4452, "polls": 940, "sleep_cyc": 0,
                   "backoff_cyc": 131007, "bank_ops": 2226, "net_stall": 177,
                   "w_served": 11998, "ops_min": 0, "ops_max": 8}),
 "colibri_workers": (dict(protocol="colibri", n_cores=64, n_addrs=1,
                          n_workers=8, net_bw=13, hol_block=16, cycles=3000,
                          backoff=128, backoff_exp=1, seed=5),
                     {"ops": 196, "msgs": 1790, "polls": 0,
                      "sleep_cyc": 160443, "backoff_cyc": 0, "bank_ops": 448,
                      "net_stall": 354, "w_served": 11993,
                      "ops_min": 0, "ops_max": 4}),
}

# ---- the main path: Fig. 3 histogram at full width --------------------
#: (protocol, cores, bins) at SimParams defaults but FULL_WIDTH_CYCLES,
#: zipf_histogram with zipf_skew=0 (uniform bins)
FULL_WIDTH_POINTS = (("colibri", 256, 1), ("colibri", 256, 256),
                     ("lrsc", 256, 1), ("lrsc", 256, 256),
                     ("colibri", 1024, 1))
#: simulated cycles of those points: the paper's 20 000 (one launch of
#: the engine_run kernel runs a point in tens of milliseconds)
FULL_WIDTH_CYCLES = 20_000
#: the reference's values for those points (repro.sync.run, xla_cpu)
FULL_WIDTH_REF = {
 "colibri/256/1": {
    "ops": 1316, "msgs": 11546, "polls": 0, "sleep_cyc": 5047667,
    "backoff_cyc": 0, "bank_ops": 2887, "net_stall": 0, "ops_min": 5,
    "ops_max": 6, "lat_hist_sum": 1316, "lat_max": 4082, "throughput":
    0.0658, "jain_fairness": 0.9954476898175397, "energy_pj_per_op":
    121.97751835945519},
 "colibri/256/256": {
    "ops": 150414, "msgs": 603226, "polls": 0, "sleep_cyc": 3178,
    "backoff_cyc": 0, "bank_ops": 301035, "net_stall": 535, "ops_min": 587,
    "ops_max": 588, "lat_hist_sum": 150414, "lat_max": 38, "throughput":
    7.5207, "jain_fairness": 0.9999992844889197, "energy_pj_per_op":
    3.006174464066015},
 "lrsc/256/1": {
    "ops": 202, "msgs": 39990, "polls": 9773, "sleep_cyc": 0, "backoff_cyc":
    3181329, "bank_ops": 19995, "net_stall": 0, "ops_min": 0, "ops_max": 5,
    "lat_hist_sum": 202, "lat_max": 19917, "throughput": 0.0101,
    "jain_fairness": 0.3777029028436019, "energy_pj_per_op":
    847.9332441822619},
 "lrsc/256/256": {
    "ops": 122101, "msgs": 504118, "polls": 3847, "sleep_cyc": 0,
    "backoff_cyc": 873078, "bank_ops": 252059, "net_stall": 16, "ops_min":
    310, "ops_max": 576, "lat_hist_sum": 122101, "lat_max": 2730,
    "throughput": 6.10505, "jain_fairness": 0.9909470155320287,
    "energy_pj_per_op": 3.0730100606274298},
 "colibri/1024/1": {
    "ops": 1266, "msgs": 14218, "polls": 0, "sleep_cyc": 19913121,
    "backoff_cyc": 0, "bank_ops": 3555, "net_stall": 11595, "ops_min": 1,
    "ops_max": 2, "lat_hist_sum": 1266, "lat_max": 16357, "throughput":
    0.0633, "jain_fairness": 0.8943950892857143, "energy_pj_per_op":
    519.8547404268566}}


#: the Fig. 3 histogram's bin counts (benchmarks/bench_histogram.py)
SWEEP_BINS = (1, 4, 16, 64, 256, 1024)

#: (cores, banks) of the kernel-vs-plain phases: every shape the golden,
#: main-path and sweep phases run (a swept point's banks are its
#: power-of-two bucket), plus (1024, 256) and the reference's multi-tile
#: case (2048, 512)
KERNEL_SHAPES = tuple(sorted(
    {(c["n_cores"], c["n_addrs"]) for c in GOLDEN_CONFIGS}
    | {(c["n_cores"], c["n_addrs"]) for c, _ in GOLDEN_EXTRA.values()}
    | {(n, bins) for _, n, bins in FULL_WIDTH_POINTS}
    | {(256, bins) for bins in SWEEP_BINS}
    | {(1024, 256), (2048, 512)}))


# ---- the trace path: the main path's 256-core points, traced ---------
#: (protocol, cores, bins) of the trace phase, each with record_trace and
#: 64 telemetry windows at TRACE_CYCLES
TRACE_POINTS = FULL_WIDTH_POINTS[:4]
#: simulated cycles of the traced points: kept at 5 000, so the host-side
#: views (events, spans, the Perfetto JSON) and the reference values
#: below stay as they were
TRACE_CYCLES = 5_000
#: points whose Perfetto JSON is hashed (2 617 and 15 276 spans); at 256
#: bins (~0.2 M spans) the span counts are compared instead
PERFETTO_HASHED = (("colibri", 256, 1), ("lrsc", 256, 1))
#: result arrays hashed (sha256 of their bytes in this dtype, C order)
TRACE_ARRAYS = {"trace_step": "<i4", "trace_wait": "<i4",
                "trace_state": "i1", "trace_qlen": "<i4", "tele": "<i4"}
#: the reference's values for those points (repro.sync.run, xla_cpu,
#: repro.core.metrics.trace_latency_hist, repro.obs), as trace_record
#: computes them
TRACE_REF = {
 "colibri/256/1": {
    "ops": 316, "msgs": 3546, "polls": 0, "sleep_cyc": 1236667,
    "backoff_cyc": 0, "bank_ops": 887, "net_stall": 0, "ops_min": 1,
    "ops_max": 2, "lat_hist_sum": 316, "lat_max": 4082, "throughput":
    0.0632, "jain_fairness": 0.8946387614678899, "energy_pj_per_op":
    131.61526501141955, "lat_p50": 2616.0, "lat_p95": 3857.0,
    "trace_step_sha256":
    "39a35ddb446a47c0deaba6f0c6783f37d4f03363a8978659062bc5c5703570e8",
    "trace_wait_sha256":
    "dfec94dafb0b6269ef4130239b71cd2d23591305a7d3e418e7605220255ad91e",
    "trace_state_sha256":
    "faf9260b13dc1a1cc81700b9cf2ad28cd6cd033a4ab8d5870785f973e5228c1f",
    "trace_qlen_sha256":
    "2e4b56753e3f63b4d4d068039404d8c908f3ddef8c36ad5a63abf576c1695030",
    "tele_sha256":
    "f697a4e476565d5bb7d8da711dc9d6f5f41f43a3e94b3806971e3121f230f5de",
    "trace_latency_hist": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 4, 4, 6, 6, 8, 9, 11,
    13, 15, 19, 21, 26, 31, 37, 103, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0], "spans": {"WORK": 525, "REQ": 888, "SLEEP": 570, "MOD": 317,
    "BACKOFF": 0, "RESP": 317, "BARWAIT": 0}, "perfetto_sha256":
    "5709789f7cee22c74bc0b14dc46b7d1f8cdb01344275e2585782ae830574b479"},
 "colibri/256/256": {
    "ops": 37505, "msgs": 151440, "polls": 0, "sleep_cyc": 3178,
    "backoff_cyc": 0, "bank_ops": 75142, "net_stall": 535, "ops_min": 146,
    "ops_max": 147, "lat_hist_sum": 37505, "lat_max": 38, "throughput":
    7.501, "jain_fairness": 0.9999883531083993, "energy_pj_per_op":
    3.010395383266077, "lat_p50": 24.0, "lat_p95": 24.0,
    "trace_step_sha256":
    "ab0d58af84d382d2d8c56f7dd79aa30ff0ee6b9ccf9e97eabdde92248ce5ce6f",
    "trace_wait_sha256":
    "94076e50a15c38783ea30d100fc8cf52439146a87204ee57357c05f71524abbd",
    "trace_state_sha256":
    "9d547cdf11e45e3da8f0500c7cfb03c6e97e331d34b0df0f3be235dc4095d6b2",
    "trace_qlen_sha256":
    "2e3779ab3c9ce23fa8292d65a5cfc113cc3616f7014f149c5be6297bc752a4dc",
    "tele_sha256":
    "6cb86f999bc743d7095e3441ff732e77c7e8dd1792aff87f1b37e126aeec45af",
    "trace_latency_hist": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 37111, 257, 136, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0], "spans": {"WORK": 37714, "REQ": 75199, "SLEEP": 289, "MOD":
    37622, "BACKOFF": 0, "RESP": 74853, "BARWAIT": 0}},
 "lrsc/256/1": {
    "ops": 47, "msgs": 9990, "polls": 2426, "sleep_cyc": 0, "backoff_cyc":
    739119, "bank_ops": 4995, "net_stall": 0, "ops_min": 0, "ops_max": 4,
    "lat_hist_sum": 47, "lat_max": 4850, "throughput": 0.0094,
    "jain_fairness": 0.10652970679012345, "energy_pj_per_op":
    1016.7467341813934, "lat_p50": 2034.0, "lat_p95": 4644.0,
    "trace_step_sha256":
    "1c9212c36e84eb55a3ccdf55444d6d3265580e1e597063c23df23471728bb3a6",
    "trace_wait_sha256":
    "168c4424e3a1c0fc9839eb039f34c3ac605b16eba1e46bb02a4410162514b8a2",
    "trace_state_sha256":
    "f49678a7a8291a941802e5ae9a443369e01aa2a8cf7d175ac62ae78de1c378c6",
    "trace_qlen_sha256":
    "28b4f41a7f3ee6d8cc87272db6e09c6d3566551fd4d18702b041a21658272a85",
    "tele_sha256":
    "c946b755994148473a0346d68791fd52317f23299b54bdea895bae7b0d4d389c",
    "trace_latency_hist": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 6, 0, 2, 1, 0, 2, 0, 0, 1, 1,
    2, 2, 1, 4, 3, 3, 5, 5, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "spans": {"WORK": 256, "REQ": 5082, "SLEEP": 0, "MOD": 2518, "BACKOFF":
    2425, "RESP": 4995, "BARWAIT": 0}, "perfetto_sha256":
    "6d1482c05938ee0560c4157d829b2fb440b74c6b8f63add11a908ce3a0657ee9"},
 "lrsc/256/256": {
    "ops": 28716, "msgs": 120116, "polls": 1238, "sleep_cyc": 0,
    "backoff_cyc": 271261, "bank_ops": 60058, "net_stall": 16, "ops_min":
    51, "ops_max": 147, "lat_hist_sum": 28716, "lat_max": 2021,
    "throughput": 5.7432, "jain_fairness": 0.9690935956611839,
    "energy_pj_per_op": 3.1035860091922562, "lat_p50": 24.0, "lat_p95":
    24.0, "trace_step_sha256":
    "68d11886b059d482b8613994116af9f450e0d3477d863b9a864940472ccd170e",
    "trace_wait_sha256":
    "f4671f76ffe305630fe16a2035e92bf06cc722b3c12260232ed16563c05c353f",
    "trace_state_sha256":
    "445b8dd0a737211d648236f32bdc6696e6d06077d1037901a9dc943099aa0997",
    "trace_qlen_sha256":
    "ef462bde948ae6e5bceaa382442a3a579edf0be3aa416b54a536843798a13010",
    "tele_sha256":
    "0296e62f8caf0c0ac1fe4371123bb53a311a3dac637db7912cfa66e643ab1556",
    "trace_latency_hist": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 27886, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 136, 446, 0, 0, 0, 0, 182,
    1, 0, 48, 0, 11, 4, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0], "spans": {"WORK": 28925, "REQ": 60114, "SLEEP": 0, "MOD":
    30037, "BACKOFF": 1238, "RESP": 60058, "BARWAIT": 0}}}

# ---- the colibri_scatter kernel -----------------------------------------
#: (T, bins, d, dtype) of the scatter_kernel phase: the reference tests'
#: shapes in both dtypes (513 x 1 x 4: the whole stream in one bin), the
#: trace path's (its four points' completion counts into the 64 latency
#: bins) and two large cases
SCATTER_SHAPES = tuple(
    [(t, b, d, dt) for dt in ("float32", "bfloat16")
     for t, b, d in ((100, 7, 1), (1000, 64, 8), (2048, 300, 16),
                     (513, 1, 4))]
    + [(t, 64, 1, "float32") for t in (37_505, 28_716, 316, 47)]
    + [(1 << 20, 64, 1, "float32"), (1 << 16, 1024, 128, "float32")])
#: dtype -> (rtol, atol), tests/test_kernels.py's
SCATTER_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (0.15, 1.5)}
#: the trace path's largest shape: the kernels line's times
SCATTER_HEAD = (37_505, 64, 1, "float32")
#: (T, bins) of the skewed stream: keys from a Zipf law with exponent 2
#: over the bins (``skewed_keys``: 61 % of the rows in bin 0), d 1, f32
SCATTER_SKEW = (1 << 20, 64)
#: the trace points whose streams (37 505 and 28 716 keys, 98.9 % and
#: 97.1 % in one bin) tools/kernel_ab.py times, parent against this tree
SCATTER_TRACE_TIMED = ("colibri/256/256", "lrsc/256/256")

# ---- the LM serve path: recurrentgemma-2b through ServeEngine ---------
SERVE_ARCH = "recurrentgemma-2b"
#: (b, sq, skv, h, kv, hd, causal, dtype) of the flash_kernel phase: the
#: reference tests' shapes (tests/test_kernels.py, causal only where
#: sq == skv) in both dtypes, the smoke config's head dim 32, head dim
#: 256 in f32, and the serve path's prefill shapes (phase serve_a: two
#: 256-token prompts, f32; serve_b: four 512-token prompts, bf16, also
#: in f32 to hold its long rows to the f32 tolerance); then head dim 112
#: (kimi-k2-1t-a32b's 64 heads on 8): an odd non-causal shape and the
#: moe_serve_a (f32) and moe_serve_b (bf16) prefill shapes; the two bf16
#: serve shapes also without the causal mask (bf16 runs the tensor-core
#: design, f32 the CUDA-core one: each meets every mask branch); then
#: whisper-large-v3's attention at hd 64, H = KV = 20, at every shape of
#: whisper_serve_b (bf16: the encoder over 1 500 frames, 46 full 32-key
#: tiles and one of 28; the decoder's causal self-attention; its
#: cross-attention, 128 positions against the 1 500 frames) and of
#: whisper_serve_a (f32: the same at two requests of 64 tokens), and the
#: cross shape also in f32; and phi-3-vision-4.2b's head dim 96 (32 heads
#: on 32): phi_serve_b's prefill shape (bf16), phi_serve_a's (f32), a
#: causal f32 one (two 256-token prompts) and a ragged non-causal GQA one
#: in both dtypes; and stablelm-3b's head dim 80 (32 heads on 32), causal
#: at four 512-token prompts, in both dtypes
FLASH_SHAPES = tuple(
    [(b, sq, skv, h, kv, hd, c, dt) for dt in ("float32", "bfloat16")
     for b, sq, skv, h, kv, hd in ((2, 128, 128, 4, 4, 64),
                                   (1, 200, 200, 4, 2, 32),
                                   (2, 64, 256, 2, 1, 64))
     for c in (True, False) if not (c and sq != skv)]
    + [(2, 40, 40, 4, 1, 32, True, "float32"),
       (1, 96, 96, 10, 1, 256, False, "float32"),
       (2, 256, 256, 10, 1, 256, True, "float32"),
       (4, 512, 512, 10, 1, 256, True, "float32"),
       (4, 512, 512, 10, 1, 256, True, "bfloat16"),
       (4, 512, 512, 10, 1, 256, False, "bfloat16"),
       (1, 100, 100, 8, 2, 112, False, "bfloat16"),
       (2, 256, 256, 64, 8, 112, True, "float32"),
       (4, 512, 512, 64, 8, 112, False, "bfloat16"),
       (4, 512, 512, 64, 8, 112, True, "bfloat16"),
       (2, 1500, 1500, 20, 20, 64, False, "float32"),
       (2, 64, 64, 20, 20, 64, True, "float32"),
       (2, 64, 1500, 20, 20, 64, False, "float32"),
       (4, 1500, 1500, 20, 20, 64, False, "bfloat16"),
       (4, 128, 128, 20, 20, 64, True, "bfloat16"),
       (4, 128, 1500, 20, 20, 64, False, "bfloat16"),
       (4, 128, 1500, 20, 20, 64, False, "float32"),
       (4, 512, 512, 32, 32, 96, True, "bfloat16"),
       (2, 512, 512, 32, 32, 96, True, "float32"),
       (2, 256, 256, 32, 32, 96, True, "float32"),
       (1, 100, 100, 4, 2, 96, False, "float32"),
       (1, 100, 100, 4, 2, 96, False, "bfloat16"),
       (4, 512, 512, 32, 32, 80, True, "float32"),
       (4, 512, 512, 32, 32, 80, True, "bfloat16")])
#: dtype -> (rtol, atol) of the kernel against its plain version on the
#: card.  f32: tests/test_kernels.py's.  bf16: both sum in f32 and round
#: the output to bf16 once, and the tensor-core design also rounds P to
#: bf16 once, so they differ by about one bf16 step of o (worst 1.56e-2,
#: at |o| near 2 where the bound is 3e-2; tests/test_torch_
#: tensorcore_numerics.py emulates that rounding on the CPU); 1e-2 is
#: well under the typical |o| of 0.07-0.1 at these shapes, so a dropped
#: key tile or a mis-rescaled accumulator shows.  (The CPU tests against
#: the Pallas kernel keep tests/test_kernels.py's 2e-2 / 1e-1.)
FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}
#: the serve path's full-depth prefill shape: the kernels line's times
FLASH_HEAD = (4, 512, 512, 10, 1, 256, True, "bfloat16")
#: moe_serve_b's prefill shape (head dim 112), timed beside it
FLASH_MOE = (4, 512, 512, 64, 8, 112, True, "bfloat16")
#: whisper_serve_b's prefill shapes at four requests (the encoder over
#: 1 500 frames; the cross-attention, 128 positions against them) and
#: phi_serve_b's (head dim 96), timed beside it
FLASH_ENCODER = (4, 1500, 1500, 20, 20, 64, False, "bfloat16")
FLASH_CROSS = (4, 128, 1500, 20, 20, 64, False, "bfloat16")
FLASH_HD96 = (4, 512, 512, 32, 32, 96, True, "bfloat16")
#: (T, B, w) of the rglru_kernel phase: the reference tests' shapes, the
#: serve path's (serve_a: 256 x 2, serve_b: 512 x 4, width 2560) and the
#: kernel's edges: one step, T a 64-step tile +- 1, widths that are not a
#: multiple of the 128-lane tile (60, 200) or of 4 (6: rows staged by the
#: threads, not by TMA), and 70 tiles of steps (a look-back over up to 69
#: earlier tiles).  Each runs on contiguous (T, B, w) inputs and on
#: the model's (T, B, w) views of (B, T, w) tensors
RGLRU_SHAPES = ((64, 2, 128), (100, 3, 60), (256, 1, 256), (256, 2, 2560),
                (512, 4, 2560), (1, 2, 60), (63, 2, 200), (65, 3, 6),
                (4480, 1, 256))
#: tests/test_kernels.py's rtol and atol (the sum order differs)
RGLRU_TOL = (1e-4, 1e-4)
RGLRU_HEAD = (512, 4, 2560)
#: serve_a: full width, one (rglru, rglru, local) unit, f32 weights
#: seeded on the card and copied to the CPU; 2 requests x 256 tokens, 8
#: new; card logits (kernels) against the port's CPU logits (plain
#: versions), teacher-forced on the CPU's tokens
SERVE_A = dict(layers=3, requests=2, prompt=256, new=8, seed=13)
#: kernel launches of one serve_a run (prefill and 8 decode steps)
SERVE_A_LAUNCHES = {"flash_attention": 1, "rglru_scan": 2}
#: prefill and decode logits, card vs CPU, both f32 with TF32 off: sums
#: in other orders through 3 layers of width 2560 and a 2560 x 256 000
#: head (the CPU tests hold the same model math to 2e-3 at smoke width)
SERVE_A_TOL = (2e-3, 2e-3)
#: serve_b: full width and depth (26 layers, bf16), 4 requests x 512
#: tokens, 16 new each, one batch through ServeEngine
SERVE_B = dict(requests=4, prompt=512, new=16, seed=17)
#: launches per prefill of the full model: one per local / rglru layer
SERVE_B_LAUNCHES = {"flash_attention": 8, "rglru_scan": 18}
#: bf16 dense peak of the tensor cores and the f32 CUDA-core peak (H100
#: SXM data sheet), for the operation bounds
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# ---- the LM serve path: rwkv6-1.6b through ServeEngine ----------------
RWKV_ARCH = "rwkv6-1.6b"
#: (B, T, H, hd) of the rwkv_kernel phase: the reference tests' (BH, T,
#: hd) shapes (tests/test_kernels.py) with BH as (B, H), the serve path's
#: (rwkv_serve_a: 2 x 256, rwkv_serve_b: 4 x 512, 32 heads of 64), a
#: long one and the kernel's edges: one step, T its 64-step chunk +- 1
RWKV_SHAPES = ((2, 64, 1, 32), (2, 130, 2, 64), (1, 32, 1, 16),
               (2, 256, 32, 64), (4, 512, 32, 64), (1, 4096, 32, 64),
               (1, 1, 2, 64), (2, 63, 2, 32), (1, 65, 2, 64))
#: means of x in the decay w = exp(-exp(x)), x ~ N(mean, 1): the model's
#: init (w0 ~ N(-5, 1)), the reference tests' N(-1.5, 1), and two strong
#: decays that pass the Pallas kernel's +-30 clamp inside one chunk
RWKV_DECAYS = (-5.0, -1.5, 0.0, 1.0)
#: tests/test_kernels.py's rtol and atol for the WKV (the sum order
#: differs; both compute the exact recurrence)
RWKV_TOL = (2e-3, 2e-3)
RWKV_HEAD = (4, 512, 32, 64)
#: rwkv_serve_a: full width, 2 (rwkv, rwkv_cm) layers, f32, as serve_a
RWKV_SERVE_A = dict(layers=2, requests=2, prompt=256, new=8, seed=23)
RWKV_SERVE_A_LAUNCHES = {"rwkv6_wkv": 2}
#: rwkv_serve_b: full width and depth (24 layers, bf16), as serve_b
RWKV_SERVE_B = dict(requests=4, prompt=512, new=16, seed=29)
RWKV_SERVE_B_LAUNCHES = {"rwkv6_wkv": 24}

# ---- the LM serve path: kimi-k2-1t-a32b's MoE layer through ServeEngine
MOE_ARCH = "kimi-k2-1t-a32b"
#: (E, C, d, f) of the serve path's expert GEMMs, bf16: gate/up (384, C,
#: 7168) @ (384, 7168, 2048) and down (384, C, 2048) @ (384, 2048, 7168)
#: at moe_serve_b's capacity, C = 56 in the prefill (4 x 512 tokens) and
#: 8 in decode; then deepseek-v3-671b's at mla_serve_b's, 256 experts,
#: C = 80 in the prefill and 8 in decode
GMM_SERVE = tuple((e, c, d, f) for e, cs in ((384, (56, 8)), (256, (80, 8)))
                  for c in cs for d, f in ((7168, 2048), (2048, 7168)))
#: (E, C, d, f) and dtype of the gmm_kernel phase: the reference tests'
#: shapes (tests/test_kernels.py) and an odd one (no dimension a multiple
#: of 8) in both dtypes, then the serve shapes
GMM_SHAPES = tuple(
    [(s, dt) for s in ((4, 64, 128, 256), (8, 100, 96, 64),
                       (1, 256, 512, 128), (3, 37, 100, 70))
     for dt in ("float32", "bfloat16")]
    + [(s, "bfloat16") for s in GMM_SERVE])
#: dtype -> (rtol, atol) of the kernel against its plain version:
#: tests/test_kernels.py's (rtol 1e-4 / 3e-2, atol ten times it); both
#: sum exact products in f32 and round once, so bf16 outputs differ by
#: at most about one bf16 rounding
GMM_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (3e-2, 3e-1)}
#: experts of the serve shapes' plain version per f32 product (a float32
#: copy of a whole 384-expert stack is 22.5 GB)
GMM_PLAIN_EXPERTS = 8
#: the kernels line's times: moe_serve_b's prefill gate/up shape
GMM_HEAD = GMM_SERVE[0]
#: moe_serve_a: full width, 2 layers (dense, MoE), experts cut to 32 so
#: that the CPU holds the f32 copy (~17.7 GB), f32, as serve_a
MOE_SERVE_A = dict(layers=2, experts=32, requests=2, prompt=256, new=8,
                   seed=31)
MOE_SERVE_A_LAUNCHES = {"flash_attention": 2, "grouped_matmul": 3}
MOE_DECODE_LAUNCHES = {"grouped_matmul": 3}
#: a pick of the card's router that differs from the CPU's must be a
#: near-tie: the k-th and (k+1)-th router probabilities within this
NEAR_TIE = 1e-5
#: moe_serve_b: full width with all 384 experts, depth cut to 2 layers
#: (dense, MoE), bf16; 4 requests x 512 tokens, 16 new each
MOE_SERVE_B = dict(layers=2, requests=4, prompt=512, new=16, seed=37)
MOE_SERVE_B_LAUNCHES = {"flash_attention": 2, "grouped_matmul": 3}

# ---- the LM serve paths: deepseek-v3-671b (MLA), long local prompts ---
MLA_ARCH = "deepseek-v3-671b"
#: (b, s, h, kv, hd, hdv, window, dtype) of the flash_window phase, all
#: causal over s queries and s keys: long_serve_b's band (10 heads on 1,
#: hd 256, window 2 048), a window past the sequence (which must give the
#: causal kernel's bits), mla_serve_b's prefill (128 heads, q/k 192, v
#: 128) and a ragged 192/128 one, in f32 and bf16
FLASH_WINDOW_SHAPES = tuple(
    (b, s, h, kv, hd, hdv, w, dt) for dt in ("float32", "bfloat16")
    for b, s, h, kv, hd, hdv, w in ((2, 6144, 10, 1, 256, 256, 2048),
                                    (2, 512, 10, 1, 256, 256, 4096),
                                    (4, 512, 128, 128, 192, 128, 0),
                                    (1, 777, 16, 16, 192, 128, 0)))
#: long_serve_b's and mla_serve_b's prefill shapes: the kernels line's
#: times at the band and at 192/128
FLASH_BAND = FLASH_WINDOW_SHAPES[4]
FLASH_MLA = FLASH_WINDOW_SHAPES[6]
#: mla_serve_a: full width, 2 layers (the MoE layers start at 1, so one
#: dense and one MoE), experts cut to 32 so that the CPU holds the f32
#: copy (~16.3 GB), f32, as moe_serve_a
MLA_SERVE_A = dict(layers=2, experts=32, moe_start=1, requests=2,
                   prompt=256, new=8, seed=47)
MLA_SERVE_A_LAUNCHES = {"flash_attention": 2, "grouped_matmul": 3}
#: mla_serve_b: full width with all 256 experts, depth cut to 4 (the
#: three dense layers and the first MoE layer), bf16; 4 x 512 tokens
MLA_SERVE_B = dict(layers=4, requests=4, prompt=512, new=16, seed=53)
MLA_SERVE_B_LAUNCHES = {"flash_attention": 4, "grouped_matmul": 3}
#: long_serve_a: recurrentgemma-2b as serve_a, prompts twice the window
LONG_SERVE_A = dict(layers=3, requests=2, prompt=4096, new=8, seed=59)
#: long_serve_b: full width and depth, bf16, 2 x 6 144 tokens, 16 new
LONG_SERVE_B = dict(requests=2, prompt=6144, new=16, seed=61)

# ---- the LM serve paths: whisper-large-v3 (encoder-decoder) and
# ---- phi-3-vision-4.2b (the VLM frontend) ------------------------------
WHISPER_ARCH = "whisper-large-v3"
PHI_ARCH = "phi-3-vision-4.2b"
#: whisper_serve_a: full width (d 1 280, 20 heads of 64, d_ff 5 120,
#: vocab 51 866, 1 500 frames), 2 encoder and 2 decoder layers, f32;
#: seeded frame embeddings, 2 x 64 tokens, 8 new
WHISPER_SERVE_A = dict(layers=2, enc_layers=2, requests=2, prompt=64, new=8,
                       seed=67)
#: per prefill: each encoder layer's self-attention, each decoder layer's
#: self- and cross-attention; decode is plain torch
WHISPER_SERVE_A_LAUNCHES = {"flash_attention": 6}
#: whisper_serve_b: full width and depth (32 + 32 layers, bf16), 4 x 128
#: tokens, 16 new, the engine's zero frame embeddings
WHISPER_SERVE_B = dict(requests=4, prompt=128, new=16, seed=71)
WHISPER_SERVE_B_LAUNCHES = {"flash_attention": 96}
#: phi_serve_a: full width (d 3 072, 32 heads on 32 of 96, d_ff 8 192,
#: vocab 32 064), 2 layers, f32; seeded patch embeddings of 256 patches
#: over 2 x 512-token prompts (256 text positions after them), 8 new
PHI_SERVE_A = dict(layers=2, requests=2, prompt=512, new=8, seed=73)
PHI_SERVE_A_LAUNCHES = {"flash_attention": 2}
#: phi_serve_b: full width and depth (32 layers, bf16), 4 x 512 tokens
#: (text after the engine's 256 zero patches), 16 new
PHI_SERVE_B = dict(requests=4, prompt=512, new=16, seed=79)
PHI_SERVE_B_LAUNCHES = {"flash_attention": 32}

#: the LM path's kernels: a serve point must launch each exactly as often
#: as its table says (0 where it names none)
LM_KERNELS = ("flash_attention", "rglru_scan", "rwkv6_wkv", "grouped_matmul",
              "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")

# ---- the training path: smollm-135m through run_training -------------
TRAIN_ARCH = "smollm-135m"
#: (b, sq, skv, h, kv, hd, causal, dtype) of the flash_bwd_kernel phase:
#: smollm-135m's heads at 1 024 tokens, a ragged non-causal hd-128 one,
#: the tensor-core design's two-box rows (hd 112, causal, GQA) and its
#: half-empty boxes (hd 32), and train_b's own shape (the last)
FLASH_BWD_SHAPES = ((2, 1024, 1024, 9, 3, 64, True, "float32"),
                    (2, 1024, 1024, 9, 3, 64, True, "bfloat16"),
                    (1, 777, 777, 4, 1, 128, False, "float32"),
                    (1, 777, 777, 4, 1, 128, False, "bfloat16"),
                    (1, 1024, 1024, 8, 2, 112, True, "bfloat16"),
                    (2, 1000, 1000, 4, 2, 32, False, "bfloat16"),
                    (8, 4096, 4096, 9, 3, 64, True, "bfloat16"))
FLASH_BWD_HEAD = FLASH_BWD_SHAPES[-1]
#: dtype -> (rtol, atol) of dq, dk, dv against the plain version, atol a
#: fraction of that gradient's largest magnitude: f32 sums in another
#: order; bf16 also rounds P and dS to bf16 before its products and the
#: gradients to bf16 (the plain version keeps f32)
FLASH_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
#: dtype -> atol of the forward's lse against the plain logsumexp (bf16:
#: the kernel's denominator sums P rounded to bf16)
FLASH_LSE_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
#: train_a: full width, 2 layers, f32, B 2 x 512 tokens, 2 AdamW steps,
#: card against the port's CPU run from the same weights
TRAIN_A = dict(layers=2, batch=2, seq=512, steps=2, seed=43)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2)      # examples/train_e2e.py's
#: train_a's tolerances: the loss (relative); each gradient leaf against
#: a fraction of its largest magnitude (f32 through cuBLAS and the kernels
#: against MKL and the plain versions, other sum orders); every parameter
#: after the steps, element by element, absolute: about three times the
#: worst element measured on the H100 (3.5e-5), a fifteenth of the
#: learning rates summed (1.5e-3, as far as two Adam steps move a weight
#: one way), so a flipped or lost update of any element fails.  A phase
#: whose dict sets ``excused`` lets that share of a leaf's elements past
#: the parameter tolerance, but only where the CPU's gradient was within
#: the gradient tolerance of 0 at some step (there the two sides' f32
#: gradients are not held to one sign, and Adam moves a weight by about
#: lr whatever |g|), each within ``adam_reach`` of the CPU's
TRAIN_A_TOL = dict(loss=1e-5, grad=1e-4, param=1e-4)
TRAIN_A_TOL = dict(loss=1e-5, grad=1e-4, param=1e-4)
#: train_b: full width and depth, bf16, remat, f32 moments; train_4k's
#: 4 096 tokens, the global batch cut from 256 to 8; 6 steps with a
#: checkpoint every 3, then a run that crashes at step 4 and resumes
TRAIN_B = dict(batch=8, seq=4096, steps=6, ckpt_every=3, crash_at=4)
#: launches of each kernel per train_b step: the forward once per layer
#: and again in the remat recompute, each backward kernel once per layer
TRAIN_B_LAUNCHES = {"flash_attention": 60, "flash_attention_bwd_dq": 30,
                    "flash_attention_bwd_dkdv": 30}

# ---- the training paths of recurrentgemma-2b (local and rglru layers),
# ---- whisper-large-v3 (the encoder-decoder) and phi-3-vision-4.2b (VLM)
#: ((b, sq, skv, h, kv, hd, causal, dtype), window) of the flash_bwd_kernel
#: phase beside FLASH_BWD_SHAPES: stablelm-3b's hd 80 and phi-3-vision's
#: hd 96 (32 heads on 32, causal) in both dtypes; whisper's encoder over
#: 1 500 frames and its cross-attention, 448 decoder positions against
#: them (non-causal, 20 heads on 20); recurrentgemma's band (10 heads on
#: 1, hd 256, window 2 048 over 4 096 tokens) and a ragged f32 band
FLASH_BWD_NEW = (((2, 1024, 1024, 32, 32, 80, True, "float32"), 0),
                 ((2, 1024, 1024, 32, 32, 80, True, "bfloat16"), 0),
                 ((2, 1024, 1024, 32, 32, 96, True, "float32"), 0),
                 ((2, 1024, 1024, 32, 32, 96, True, "bfloat16"), 0),
                 ((4, 1500, 1500, 20, 20, 64, False, "bfloat16"), 0),
                 ((4, 448, 1500, 20, 20, 64, False, "bfloat16"), 0),
                 ((2, 4096, 4096, 10, 1, 256, True, "bfloat16"), 2048),
                 ((1, 777, 777, 10, 1, 256, True, "float32"), 300))
#: ((b, sq, skv, h, kv, hd, causal, dtype), window) timed in
#: train_kernel_time: each new instance at its training path's shape:
#: rg_train_b's band, whisper_train_b's cross-attention (non-causal, Sq
#: != Skv), phi_train_b's hd 96, stablelm-3b's hd 80 at train_4k's 4 096
#: tokens (one sequence)
FLASH_BWD_TIMED = (((4, 4096, 4096, 10, 1, 256, True, "bfloat16"), 2048),
                   ((8, 448, 1500, 20, 20, 64, False, "bfloat16"), 0),
                   ((1, 4096, 4096, 32, 32, 96, True, "bfloat16"), 0),
                   ((1, 4096, 4096, 32, 32, 80, True, "bfloat16"), 0))
#: (T, B, w) of the rglru_bwd_kernel phase, on the model's (T, B, w) views
#: of (B, T, w) tensors: rg_train_b's (4 096 tokens, 4 sequences, width
#: 2 560) and a ragged T (a last chunk of 40 steps) and width
RGLRU_BWD_SHAPES = ((4096, 4, 2560), (1000, 3, 200))
RGLRU_BWD_HEAD = RGLRU_BWD_SHAPES[0]
#: *_train_a: full width, f32, card against the port's CPU run from the
#: same weights and batches (TRAIN_A_TOL): recurrentgemma one (rglru,
#: rglru, local) unit at 2 x 128 tokens (the CPU's side, with its 256 000
#: x 2 560 embedding and head in f32, took 88 s at 2 x 256); whisper 2
#: encoder and 2 decoder layers, 2 x 128 decoder tokens against the
#: 1 500 frames.  recurrentgemma's ``excused``: at most one element in a
#: million of a leaf past the parameter tolerance at a near-zero CPU
#: gradient; on the H100 its embedding and head had 6 and 2 such elements
#: of 655 360 000 (10 in all, up to 4.2e-4) at 2 x 128 tokens, 21 and 7
#: (33 in all, up to 1.13e-3) at 2 x 256; whisper's and smollm's none
RG_TRAIN_A = dict(layers=3, batch=2, seq=128, steps=2, seed=83,
                  excused=1e-6)
WHISPER_TRAIN_A = dict(layers=2, enc_layers=2, batch=2, seq=128, steps=2,
                       seed=89)
#: *_train_b: the training main path at full width, bf16, remat, f32
#: moments, through run_training, 3 steps (the third profiled).
#: recurrentgemma at full depth (26 layers), 4 x 4 096 tokens (the band
#: past its window of 2 048); whisper at full depth (32 + 32 layers),
#: 8 x 448 decoder tokens against 1 500 frames; phi-3-vision 4 096
#: tokens (256 patches), its depth cut 32 -> 28 (a cut of scale: the
#: AdamW update holds the old and the new f32 moments beside the bf16
#: weights and gradients, ~22 bytes a parameter; at 24 layers the step
#: peaked at 64.65 GB on the H100, 2.49 GB more a layer, so 32 layers
#: would need ~84.6 GB of the card's 85.0)
RG_TRAIN_B = dict(batch=4, seq=4096, steps=3)
WHISPER_TRAIN_B = dict(batch=8, seq=448, steps=3)
PHI_TRAIN_B = dict(layers=28, batch=1, seq=4096, steps=3)
#: AdamW of the three, one setting so that their steps compare.  Adam's
#: first steps move each weight by about lr * sign(g), so a layer's output
#: moves by about lr * |x|_1 in one direction: at these widths (1 280 -
#: 3 072) and larger rates the losses swung from step to step on the H100
#: (whisper 11.24, 12.10, 14.15 at 1e-3; recurrentgemma 12.99, 10.56,
#: 19.72 at whisper-large's published 1.75e-4); at 3e-5 each fell at every
#: step.  A smoke of the path, not a training recipe
NEW_TRAIN_OPT = dict(lr=3e-5, warmup_steps=2)
#: launches of each kernel per step: the forward once per layer and
#: again in the remat recompute, each backward kernel once per layer
RG_TRAIN_B_LAUNCHES = {"flash_attention": 16, "flash_attention_bwd_dq": 8,
                       "flash_attention_bwd_dkdv": 8, "rglru_scan": 36,
                       "rglru_scan_bwd": 18}
WHISPER_TRAIN_B_LAUNCHES = {"flash_attention": 192,
                            "flash_attention_bwd_dq": 96,
                            "flash_attention_bwd_dkdv": 96}
PHI_TRAIN_B_LAUNCHES = {"flash_attention": 56, "flash_attention_bwd_dq": 28,
                        "flash_attention_bwd_dkdv": 28}
#: every kernel a training step may launch
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkdv", "rglru_scan", "rglru_scan_bwd",
                 "rwkv6_wkv", "grouped_matmul")

KERNELS = ("engine_step", "colibri_scatter", "flash_attention",
           "flash_attention_bwd", "rglru_scan",
           "rwkv6_wkv", "grouped_matmul")

#: simulated cycles of each run_kernel case: HIER_PROTOS' at 200, the
#: others', held there since their slices, at 120 (the plain loop they
#: are held to is host-bound: these depths keep the script near half its
#: time limit)
RUN_KERNEL_CYCLES = 200
RUN_KERNEL_CYCLES_EARLIER = 120
#: (cores, banks) of the run_kernel cases in the kernel's two other
#: layouts: per-core state in device memory (more than 2 048 cores) and
#: per-bank state in the scratch buffer (more banks than shared memory
#: holds), each run over LAYOUT_CASE_CYCLES cycles
LAYOUT_CASES = ((2100, 64), (300, 7000))
LAYOUT_CASE_CYCLES = 48


# ---- the sweep: the paper's grids through Study, a launch per core count
#: the Fig. 3 uniform lines (benchmarks/bench_histogram.py): four
#: protocols and lrscwait with 8 queue slots, at these bin counts, 256
#: cores, FULL_WIDTH_CYCLES; the skewed companion lines (zipf_skew=150)
#: are the fig3_skew phase's (``FIG3_SKEW_PROTOS`` at ``FIG3_SKEW``)
SWEEP_LINES = (("amo", 256), ("lrsc", 256), ("lrscwait", 256),
               ("colibri", 256), ("lrscwait", 8))
#: launch groups of the Fig. 3 Study (one per core count: 256, and the
#: 1024-core colibri point added to it)
SWEEP_FIG3_LAUNCHES = 2
#: the mixed grid: 256 cores, one launch, every DYN_FIELDS field but
#: zipf_skew differing between its blocks (n_addrs off the power-of-two
#: buckets, so the banks are padded, each bucket a KERNEL_SHAPES entry),
#: the Fig. 5 regime (lrscwait, net_bw 13, hol_block 16, 0/64/128
#: workers) and one traced point
SWEEP_MIXED = (
    dict(protocol="lrscwait", n_addrs=1, net_bw=13, hol_block=16,
         n_workers=0, seed=1),
    dict(protocol="lrscwait", n_addrs=1, net_bw=13, hol_block=16,
         n_workers=64, seed=2),
    dict(protocol="lrscwait", n_addrs=1, net_bw=13, hol_block=16,
         n_workers=128, seed=3),
    dict(protocol="colibri", n_addrs=3, lat=3, work=6, modify=2, seed=-7),
    dict(protocol="lrsc", n_addrs=13, backoff=128, backoff_exp=1,
         seed=2**40 + 11),
    dict(protocol="lrsc", n_addrs=200, lat=8, backoff=64, backoff_exp=3,
         net_bw=32, hol_block=0, n_workers=16, seed=5),
    dict(protocol="amo", n_addrs=48, work=20, modify=1, net_bw=9, seed=6),
    dict(protocol="lrscwait", q_slots=8, n_addrs=600, lat=2, work=3,
         modify=6, hol_block=4, seed=7),
    dict(protocol="colibri", n_addrs=33, cycles=5_000, record_trace=True,
         telemetry_windows=64, seed=8),
)
#: batch sizes timed: B seeds of colibri 256 x 1 at FULL_WIDTH_CYCLES in
#: one launch (132 = the H100's SMs)
SWEEP_B = (1, 8, 32, 132, 264)
#: per-bank result arrays of a swept point padded to the bucket, with
#: their bank axis (the two-level queues' local queues have a row per
#: (bank, group), a bank's rows side by side)
BANK_AXIS = {"addr_ops": 0, "qbuf": 0, "qhead": 0, "qlen": 0,
             "wake_tmr": 0, "resv_core": 0, "resv_valid": 0, "lock": 0,
             "next_tkt": 0, "serving": 0, "feb": 0, "lqbuf": 0,
             "lqhead": 0, "lqlen": 0, "ggq": 0, "g_inq": 0, "cur_grp": 0,
             "turn_srv": 0, "gqhead": 0, "gqlen": 0, "wake_grp": 0,
             "trace_qlen": 1}

# ---- Fig. 4: colibri against the lock baselines, one launch ------------
#: the protocols of Fig. 4 (benchmarks/bench_locks.py), at SWEEP_BINS
FIG4_LOCKS = ("colibri", "amo_lock", "lrsc_lock", "ticket_lock",
              "mwait_lock")
#: simulated cycles of its points (bench_locks.py's CYCLES)
FIG4_CYCLES = 12_000
#: the 256-core points whose engine_run time the lock_time phase takes:
#: each lock at one bin beside colibri (full_width_spec, FULL_WIDTH_CYCLES)
LOCK_TIME_POINTS = tuple((pr, 256, 1) for pr in FIG4_LOCKS)

# ---- the two-level queues beside colibri and nb_feb, one launch ----------
#: (protocol, n_groups) lines of the hier phase, each at SWEEP_BINS:
#: colibri and nb_feb (one queue a bank), colibri_hier at 1 to 16 groups,
#: hw_event at 4
HIER_LINES = ((("colibri", 4), ("nb_feb", 4))
              + tuple(("colibri_hier", g) for g in (1, 2, 4, 8, 16))
              + (("hw_event", 4),))
#: simulated cycles of its points (the Fig. 4 phase's)
HIER_CYCLES = FIG4_CYCLES
#: the 256-core points whose engine_run time the hier_time phase takes,
#: each (full_width_spec, FULL_WIDTH_CYCLES) beside colibri
HIER_TIME_POINTS = (("colibri", 256, 1),) + tuple((pr, 256, 1)
                                                 for pr in HIER_PROTOS)

# ---- workload programs: the run kernel's program instance ---------------
#: the workloads with more than one step or a barrier step; the
#: run_kernel phase runs each for every protocol at its scenario's banks
#: and PROGRAM_CORES cores, untraced and traced, at
#: RUN_KERNEL_CYCLES_EARLIER cycles
PROGRAM_WORKLOADS = ("ms_queue", "treiber_stack", "barrier_phases")
PROGRAM_CORES = 256
#: a program of the script's own (tests/own_program.py's): local work and
#: modify durations that differ between steps, a barrier step
#: mid-program, every address mode (uniform, fixed, Zipf at skew 0)
OWN_PROGRAM = "own_program"
OWN_FIELDS = dict(kind=(0, 0, 1, 0), pre_mult=(1, 0, 2, 0),
                  pre_add=(0, 3, 1, 0), addr_mode=(0, 1, 1, 2),
                  addr_arg=(0, 1, 0, 0), mod_mult=(1, 0, 0, 2),
                  mod_add=(0, 5, 1, 3))
OWN_MIN_ADDRS = 2
#: the protocols whose µs per simulated cycle the program_time phase
#: takes on each PROGRAM_WORKLOADS entry (256 cores, FULL_WIDTH_CYCLES)
PROGRAM_TIME_PROTOS = ("colibri", "lrsc")

# ---- Fig. 6: the concurrent queue, one launch per core count ------------
#: benchmarks/bench_queue.py's grid: protocols × core counts, ms_queue at
#: its scenario, the paper's fixed 128-cycle backoff
FIG6_PROTOS = ("colibri", "colibri_hier", "lrsc", "amo_lock")
FIG6_CORES = (2, 8, 32, 64, 128, 256)
FIG6_CYCLES = 10_000
FIG6_KW = dict(backoff=128, backoff_exp=1)

# ---- the workload grid: benchmarks/bench_workloads.py, one launch -------
#: its workloads, protocols, seeds, core count and cycles; rmw_loop at 16
#: addresses (its OVERRIDES), zipf_histogram at its scenario (64 bins,
#: skew 1.0)
GRID_WORKLOADS = ("rmw_loop", "ms_queue", "treiber_stack",
                  "zipf_histogram", "barrier_phases")
GRID_PROTOS = ("colibri", "lrscwait", "mwait_lock", "lrsc", "amo_lock")
GRID_SEEDS = (0, 1)
GRID_CORES = 64
GRID_CYCLES = 6_000
GRID_OVERRIDES = {"rmw_loop": dict(n_addrs=16)}
#: its Zipf ladder: zipf_histogram at its scenario with these skews for
#: colibri and lrsc, one point each (seed 0); rows "zipf_s<skew/100>"
GRID_ZIPF_LADDER = (0, 100, 200)
GRID_LADDER_PROTOS = ("colibri", "lrsc")
#: tests/test_workloads.py's polling-free protocols
POLLING_FREE = ("lrscwait", "colibri", "colibri_hier", "mwait_lock")
#: the reference's Fig. 6 rows, (ops per cycle, Jain fairness) per
#: "protocol/cores": benchmarks/bench_queue.py's rows in the committed
#: reports/benchmarks.json (the JAX package, xla_cpu, 10 000 cycles;
#: tests/test_torch_programs.py holds them to the report and recomputes
#: the 2- and 8-core points with the JAX package)
FIG6_REF = {
    "colibri/2": (0.0293, 0.9999883517763541),
    "colibri/8": (0.0524, 0.9999417317328982),
    "colibri/32": (0.0523, 0.999156195207481),
    "colibri/64": (0.0521, 0.9981797187573547),
    "colibri/128": (0.0518, 0.9972793767840152),
    "colibri/256": (0.0511, 0.9990243939764937),
    "colibri_hier/2": (0.0293, 0.9999883517763541),
    "colibri_hier/8": (0.0603, 0.9999587485974523),
    "colibri_hier/32": (0.068, 0.999584947426674),
    "colibri_hier/64": (0.0692, 0.9986986118526429),
    "colibri_hier/128": (0.0695, 0.9917563239159002),
    "colibri_hier/256": (0.069, 0.971664380877743),
    "lrsc/2": (0.0291, 0.999893730074389),
    "lrsc/8": (0.0435, 0.9479830467716724),
    "lrsc/32": (0.0444, 0.8506628003314002),
    "lrsc/64": (0.0455, 0.8546276420079261),
    "lrsc/128": (0.0156, 0.5463362068965517),
    "lrsc/256": (0.005, 0.16837284482758622),
    "amo_lock/2": (0.0289, 0.9997007636511622),
    "amo_lock/8": (0.0437, 0.9433362971744714),
    "amo_lock/32": (0.0449, 0.8645576025799369),
    "amo_lock/64": (0.0475, 0.9135503044830267),
    "amo_lock/128": (0.0458, 0.7657856308411215),
    "amo_lock/256": (0.0079, 0.25132893041237114)}
#: the reference's workload-grid rows, (ops per cycle averaged over the
#: seeds, polls summed over them) per "workload/protocol":
#: benchmarks/bench_workloads.py's rows in reports/benchmarks.json
GRID_REF = {
    "rmw_loop/colibri": (1.0573333333333332, 0),
    "rmw_loop/lrscwait": (1.2111666666666667, 0),
    "rmw_loop/mwait_lock": (1.0573333333333332, 0),
    "rmw_loop/lrsc": (0.5095, 2166),
    "rmw_loop/amo_lock": (0.5454166666666667, 2993),
    "ms_queue/colibri": (0.051833333333333335, 0),
    "ms_queue/lrscwait": (0.057833333333333334, 0),
    "ms_queue/mwait_lock": (0.051833333333333335, 0),
    "ms_queue/lrsc": (0.042166666666666665, 2216),
    "ms_queue/amo_lock": (0.04533333333333334, 3978),
    "treiber_stack/colibri": (0.032, 0),
    "treiber_stack/lrscwait": (0.03333333333333333, 0),
    "treiber_stack/mwait_lock": (0.032, 0),
    "treiber_stack/lrsc": (0.022, 2346),
    "treiber_stack/amo_lock": (0.0245, 4076),
    "barrier_phases/colibri": (0.0735, 0),
    "barrier_phases/lrscwait": (0.08533333333333333, 0),
    "barrier_phases/mwait_lock": (0.0735, 0),
    "barrier_phases/lrsc": (0.0205, 1068),
    "barrier_phases/amo_lock": (0.031166666666666665, 1880),
    "zipf_histogram/colibri": (0.4215833333333333, 0),
    "zipf_histogram/lrscwait": (0.48158333333333336, 0),
    "zipf_histogram/mwait_lock": (0.4215833333333333, 0),
    "zipf_histogram/lrsc": (0.35058333333333336, 2042),
    "zipf_histogram/amo_lock": (0.37116666666666664, 3386),
    "zipf_s0.0/colibri": (1.8765, 0),
    "zipf_s1.0/colibri": (0.423, 0),
    "zipf_s2.0/colibri": (0.13416666666666666, 0),
    "zipf_s0.0/lrsc": (1.4225, 383),
    "zipf_s1.0/lrsc": (0.3465, 1019),
    "zipf_s2.0/lrsc": (0.1215, 1127)}

# ---- skewed Zipf: Fig. 3's companion lines, one launch ------------------
#: benchmarks/bench_histogram.py's skewed lines: these protocols at
#: zipf_skew FIG3_SKEW × SWEEP_BINS, 256 cores, its CYCLES; a Study runs
#: them in the sweep's form of the stream, as the reference's does
FIG3_SKEW_PROTOS = ("colibri", "lrsc")
FIG3_SKEW = 150
FIG3_SKEW_CYCLES = 12_000
#: their rows in reports/benchmarks.json, (updates per cycle, Jain
#: fairness, polls, msgs, ops) per "protocol/bins"
FIG3_SKEW_REF = {
    "colibri/1": (0.06525, 0.9941381927148194, 0, 7282, 783),
    "colibri/4": (0.13508333333333333, 0.8841607938883624, 0, 12652, 1621),
    "colibri/16": (0.16808333333333333, 0.8901447323279, 0, 13938, 2017),
    "colibri/64": (0.18166666666666667, 0.8998576102762966, 0, 14158, 2180),
    "colibri/256": (0.20791666666666667, 0.8737828849850875, 0, 15324,
                    2495),
    "colibri/1024": (0.224, 0.8746203904555314, 0, 16102, 2688),
    "lrsc/1": (0.009916666666666667, 0.2525863299086758, 5853, 23990, 119),
    "lrsc/4": (0.057166666666666664, 0.5526956178592904, 6571, 29124, 686),
    "lrsc/16": (0.08141666666666666, 0.5949623274692836, 6395, 29588, 977),
    "lrsc/64": (0.08958333333333333, 0.6043861502543848, 6279, 29500, 1075),
    "lrsc/256": (0.09116666666666666, 0.6230198061034116, 6226, 29378,
                 1094),
    "lrsc/1024": (0.09158333333333334, 0.6161646410147578, 6213, 29346,
                  1099)}
#: the points whose Zipf address stream the exact phase checks on every
#: hash: (n_addrs, zipf_skew, the sweep's form); skew 0 at counts where
#: two roundings differ from the fused multiply-add
ZIPF_PROBES = ((64, 150, False), (64, 150, True), (1000, 150, True),
               (1024, 200, False), (64, 100, False), (16384, 150, True))
ZIPF_FMA_BINS = (43, 92, 554, 1000)

# ---- hierarchical topologies: benchmarks/bench_topology.py --------------
#: its protocol × topology matrix at each TOPO_CORES, TOPO_CYCLES,
#: TOPO_ADDRS addresses, TOPO_CLUSTERS leaf clusters, and colibri_hier's
#: ladder at 256 cores, as one Study (a launch per core count)
TOPO_CORES = (256, 1024)
TOPO_CYCLES = 12_000
TOPO_CLUSTERS = 4
TOPO_ADDRS = 4
TOPO_MATRIX = (("colibri", "flat"), ("lrsc", "flat"),
               ("colibri", "cluster2"), ("lrsc", "cluster2"),
               ("colibri_hier", "cluster2"), ("hw_event", "cluster2"),
               ("nb_feb", "cluster2"))
TOPO_LADDER = ("flat", "cluster2", "cluster3")
TOPO_LAUNCHES = len(TOPO_CORES)
#: its rows in reports/benchmarks.topology.json, (ops per cycle, Jain
#: fairness, polls, msgs, ops, hops per op) per row name
TOPO_REF = {
    "colibri_flat_256c": (0.26525, 0.9984139081775524, 0, 26468, 3183, 0.0),
    "lrsc_flat_256c": (0.21541666666666667, 0.8300983115360152, 9153, 46994,
                       2585, 0.0),
    "colibri_cluster2_256c": (0.18933333333333333, 0.9986133122028527, 0,
                              19188, 2272, 10.581866197183098),
    "lrsc_cluster2_256c": (0.15791666666666668, 0.8105068126336165, 8800,
                           42822, 1895, 55.53245382585752),
    "colibri_hier_cluster2_256c": (0.2455, 0.9736922173875582, 0, 18652,
                                   2946, 10.494908350305499),
    "hw_event_cluster2_256c": (0.262, 0.9817505720823798, 0, 13232, 3144,
                               10.534351145038167),
    "nb_feb_cluster2_256c": (0.20933333333333334, 0.9984202851587816, 0,
                             10552, 2512, 10.511146496815286),
    "colibri_flat_1024c": (0.2613333333333333, 0.9937913907284768, 0, 29160,
                           3136, 0.0),
    "lrsc_flat_1024c": (0.04008333333333333, 0.30491022478070173, 23412,
                        95960, 481, 0.0),
    "colibri_cluster2_1024c": (0.18516666666666667, 0.9709155066955296, 0,
                               21848, 2222, 12.453645364536454),
    "lrsc_cluster2_1024c": (0.04033333333333333, 0.3151041666666667, 23416,
                            95960, 484, 497.801652892562),
    "colibri_hier_cluster2_1024c": (0.23933333333333334, 0.8207726207458732,
                                    0, 20347, 2872, 11.928969359331477),
    "hw_event_cluster2_1024c": (0.26066666666666666, 0.7716897512518172, 0,
                                14598, 3128, 11.512787723785166),
    "nb_feb_cluster2_1024c": (0.20425, 0.9600069610640648, 0, 11840, 2451,
                              12.243166054671562),
    "ladder_flat": (0.3888333333333333, 0.9934251544832259, 0, 29075, 4666,
                    0.0),
    "ladder_cluster2": (0.2455, 0.9736922173875582, 0, 18652, 2946,
                        10.494908350305499),
    "ladder_cluster3": (0.19383333333333333, 0.9805089832513687, 0, 14871,
                        2326, 14.545141874462598)}
#: topology points held against the plain loop on the card (its cost,
#: ~3 ms a cycle, cuts their cycles to TOPO_PLAIN_CYCLES)
TOPO_PLAIN = (("colibri", "cluster2", 256), ("lrsc", "cluster3", 256),
              ("hw_event", "cluster2", 1024))
TOPO_PLAIN_CYCLES = 300
#: the run_kernel phase's topology and Zipf cases: every protocol on both
#: hierarchical topologies at (TOPO_KERNEL_CORES, TOPO_ADDRS) with a
#: network budget whose levels' share turns requests away, and the run
#: kernel's other register layouts on cluster3
TOPO_KERNEL_CORES = 256
TOPO_KERNEL_NET_BW = 13
TOPO_KERNEL_LAYOUTS = ((1100, 16), (2100, 64))
#: (protocol, bins, skew, the sweep's form) of the run_kernel phase's
#: skewed Zipf cases, 256 cores
ZIPF_KERNEL_CASES = (("lrsc", 1000, 150, False), ("colibri", 1000, 150,
                                                  True),
                     ("amo_lock", 64, 200, True), ("colibri", 64, 100,
                                                   False),
                     ("lrsc", 43, 0, False), ("colibri_hier", 1024, 200,
                                              False))
#: the topo_time phase: colibri at 256 cores and TOPO_ADDRS addresses on
#: each topology (flat also on the topology instance), and the Zipf
#: lookup: colibri and lrsc at 256 × 1024 bins, skew 0 beside
#: ZIPF_TIME_SKEW, all at FULL_WIDTH_CYCLES
ZIPF_TIME_SKEW = 150

# ---- faults: the fault instance of the run kernel, bench_faults.py
#: the run_kernel phase's fault plan (``fault_params``): a holder kill at
#: cycle 20, a 16-cycle watchdog, 3 % request and wakeup drops, one bank
#: stalled over cycles 60-100 and an 80-cycle progress threshold (at
#: 256 × 4 over RUN_KERNEL_CYCLES the queue protocols evict and
#: redeliver, lrsc and ticket_lock are flagged halted)
FAULT_KERNEL_PLAN = dict(n_kill=2, kill_cyc=20, watchdog_cyc=16,
                         msg_drop_bp=300, n_bank_stall=1, bank_stall_cyc=60,
                         bank_stall_dur=40, progress_cyc=80)
#: the traced fault cases' plan: a uniform kill, a stall window past the
#: horizon, drops and the watchdog
FAULT_TRACED_PLAN = dict(n_kill=3, kill_cyc=30, kill_holder=0, n_stall=8,
                         stall_cyc=40, stall_dur=400, msg_drop_bp=300,
                         watchdog_cyc=16, progress_cyc=80)
#: benchmarks/bench_faults.py (full size): cores, cycles, addresses, the
#: owner kill (its watchdog varies per row), the liveness protocols, the
#: drop curve's protocols and rates (basis points) and the watchdog
#: ablation's timeouts
FAULTS_CORES, FAULTS_CYCLES, FAULTS_ADDRS = 64, 12_000, 4
FAULTS_KILL = dict(n_kill=2, kill_cyc=500, kill_holder=1, watchdog_cyc=64,
                   progress_cyc=600)
FAULTS_PROTOS = ("lrscwait", "colibri", "colibri_hier", "mwait_lock",
                 "lrsc", "lrsc_lock", "amo_lock", "ticket_lock", "amo")
FAULTS_DROP_PROTOS = ("lrscwait", "colibri", "mwait_lock")
FAULTS_DROPS = (0, 50, 100, 200, 400)
FAULTS_WD = (0, 32, 64, 128, 256)
#: the committed report the faults phase's rows are held to, and the
#: keys the reference's ``Result.to_row`` has added to every row since
#: it was written, with their value at these points (flat runs)
FAULTS_REPORT = ROOT / "reports" / "benchmarks.faults.json"
FAULTS_ROW_ADDED = {"topology": "flat"}
#: fault_time: these protocols at 256 × 1 over FULL_WIDTH_CYCLES
FAULT_TIME_PROTOS = ("colibri", "lrsc")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def full_width_spec(proto: str, n: int, bins: int) -> Spec:
    return Spec(protocol=proto, workload="zipf_histogram", zipf_skew=0,
                n_cores=n, n_addrs=bins, cycles=FULL_WIDTH_CYCLES)


def observe(r) -> dict:
    """The reference test suite's summary of one result dict."""
    obs = {"ops": int(r["ops"].sum()), "msgs": int(r["msgs"]),
           "polls": int(r["polls"]), "sleep_cyc": int(r["sleep_cyc"]),
           "backoff_cyc": int(r["backoff_cyc"]),
           "bank_ops": int(r["bank_ops"]), "net_stall": int(r["net_stall"]),
           "ops_min": int(r["ops"].min()), "ops_max": int(r["ops"].max())}
    if "w_served" in r:
        obs["w_served"] = int(np.asarray(r["w_served"]).sum())
    return obs


def full_width_summary(r) -> dict:
    """``observe`` plus the latency accumulators and the metric triple."""
    out = observe(r)
    out.pop("w_served", None)
    out["lat_hist_sum"] = int(r["lat_hist"].sum())
    out["lat_max"] = int(r["lat_max"])
    for k in ("throughput", "jain_fairness", "energy_pj_per_op"):
        out[k] = float(r[k])
    return out


def trace_spec(proto: str, n: int, bins: int) -> Spec:
    return full_width_spec(proto, n, bins).replace(
        cycles=TRACE_CYCLES, record_trace=True, telemetry_windows=64)


def trace_record(stats, log, hist, perfetto_json=None) -> dict:
    """What the trace phase holds against the reference: the summary,
    the exact-waits latency percentiles, the sha256 of each trace array
    and of the telemetry, the trace latency histogram ``hist``, the
    span count of each state over all cores (from the ``EventLog``
    ``log``) and the sha256 of the Perfetto JSON bytes, if given."""
    out = full_width_summary(stats)
    out["lat_p50"] = float(stats["lat_p50"])
    out["lat_p95"] = float(stats["lat_p95"])
    for k, dt in TRACE_ARRAYS.items():
        out[f"{k}_sha256"] = hashlib.sha256(np.ascontiguousarray(
            stats[k], dtype=dt).tobytes()).hexdigest()
    out["trace_latency_hist"] = [int(v) for v in hist]
    out["spans"] = {name: int(log.span_counts(code).sum())
                    for code, name in sorted(STATE_NAMES.items())}
    if perfetto_json is not None:
        out["perfetto_sha256"] = hashlib.sha256(perfetto_json).hexdigest()
    return out


class Failed(Exception):
    """A phase's check failed."""


#: the card's ``nvidia-smi`` name and power limit, once read; every
#: record carries it beside its numbers
CARD = {}


def emit(**rec) -> None:
    print(json.dumps(dict(rec, **CARD)), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---- phase 3 helpers ----------------------------------------------------

def random_hier_bank(bank: dict, n: int, a: int, groups: int, gsz: int,
                     cap_l: int, rng) -> None:
    """Fill ``bank``, the two-level queues' state (numpy, in place), with
    a seeded random state of the shape the protocols reach: per bank a
    serving group (``cur_grp``, -1 idle), distinct registered groups
    other than it in the ``ggq`` window at ``gqhead`` (their ``g_inq``
    set, stale slots -1), sleepers only in the serving and registered
    groups' local queues (at least one in each registered one, each a
    distinct member core of its group) and ``wake_grp`` a group.  Every
    live index is in range, so no group id -1 is ever read from ``ggq``
    (it would wrap to the last group in torch and not in CUDA)."""
    members = [np.arange(g * gsz, n if g == groups - 1 else (g + 1) * gsz)
               for g in range(groups)]
    for b in range(a):
        cur = -1 if rng.random() < 0.2 else int(rng.integers(groups))
        others = [g for g in range(groups) if g != cur]
        k = 0 if cur < 0 else int(rng.integers(0, len(others) + 1))
        reg = list(rng.permutation(others)[:k])
        head = int(rng.integers(groups))
        bank["cur_grp"][b], bank["gqhead"][b], bank["gqlen"][b] = \
            cur, head, k
        for j, g in enumerate(reg):
            bank["ggq"][b, (head + j) % groups] = g
            bank["g_inq"][b, g] = True
        for g in range(groups):
            row = b * groups + g
            pool = members[g]
            live = (int(rng.integers(1, len(pool) + 1)) if g in reg
                    else int(rng.integers(0, len(pool) + 1)) if g == cur
                    else 0)
            h = int(rng.integers(cap_l))
            bank["lqhead"][row], bank["lqlen"][row] = h, live
            for j, c in enumerate(rng.permutation(pool)[:live]):
                bank["lqbuf"][row, (h + j) % cap_l] = c
        bank["wake_grp"][b] = cur if cur >= 0 else int(rng.integers(groups))
        bank["wake_tmr"][b] = int(rng.integers(0, 8))
        if "turn_srv" in bank:
            bank["turn_srv"][b] = int(rng.integers(0, gsz + 2))


def random_bank(proto, p, a, n, q_cap, rng) -> dict:
    """Seeded random bank state of the protocol's layout (numpy): lrsc's
    reservations, the queues (nb_feb's full/empty bits drawn apart from
    its queue lengths), the lock bits, the ticket dispensers and the
    two-level queues (``random_hier_bank``)."""
    bank = convert.to_numpy(proto.init_bank_state(p, a, n, q_cap, "cpu"))
    if "lqbuf" in bank:
        args = proto.kernel_args(p)
        random_hier_bank(bank, n, a, args.groups, args.group_size,
                         args.group_cap, rng)
        return bank
    if "feb" in bank:
        bank["feb"] = rng.random(a) < 0.5
    if "resv_core" in bank:
        bank["resv_core"] = rng.integers(-1, n, a).astype(np.int32)
        bank["resv_valid"] = rng.random(a) < 0.5
    if "qbuf" in bank:
        bank["qbuf"] = rng.integers(-1, n, (a, q_cap)).astype(np.int32)
        bank["qhead"] = rng.integers(0, q_cap, a).astype(np.int32)
        bank["qlen"] = rng.integers(0, q_cap + 1, a).astype(np.int32)
        bank["wake_tmr"] = rng.integers(0, 8, a).astype(np.int32)
    if "lock" in bank:
        bank["lock"] = rng.random(a) < 0.5
    if "next_tkt" in bank:
        bank["next_tkt"] = rng.integers(0, 8, a).astype(np.int32)
        bank["serving"] = rng.integers(0, 8, a).astype(np.int32)
    return bank


#: per-core inputs of a step that are a protocol's per-core state
CORE_FIELDS = ("tkt",)


def random_step(n, a, cyc, rng) -> dict:
    """Seeded random per-core inputs of one engine step (numpy), with a
    held ticket per core (-1 for none) for the protocols that read it."""
    shift = int(rng.integers(0, n))
    cand = rng.integers(0, cyc + 1, n).astype(np.int32)
    cand[rng.random(n) < 0.5] = sim._BIG
    return dict(cand_cyc=cand,
                rot=((np.arange(n) + shift) % n).astype(np.int32),
                addr=rng.integers(0, a, n).astype(np.int32),
                phase=rng.integers(0, 2, n).astype(np.int32),
                acq_start=rng.integers(0, cyc + 1, n).astype(np.int32),
                shift=shift, tkt=rng.integers(-1, 8, n).astype(np.int32))


def step_kwargs(inputs, dev, cyc, p, n, a, q_cap, cycles) -> dict:
    fields = protocols.get(p.protocol).fused_core_fields
    kw = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()
          if k != "shift" and k not in CORE_FIELDS}
    kw.update(core={f: torch.from_numpy(inputs[f]).to(dev) for f in fields},
              cyc=cyc, shift=inputs["shift"], lat=p.lat, n=n, a=a,
              q_cap=q_cap, cycles=cycles)
    return kw


def compare(out_k, out_r) -> int:
    """Max |kernel - plain| over every output, bank array and per-core
    write (values and mask); raises on a dtype or shape mismatch or on
    different per-core fields."""
    worst = 0
    keys = ("valid", "win", "kind", "tmr", "polls", "msgs", "hist",
            "lat_max")
    pairs = [(k, out_k[k], out_r[k]) for k in keys]
    pairs += [(f"bank.{k}", out_k["bank"][k], out_r["bank"][k])
              for k in out_r["bank"]]
    require(set(out_k["xset"]) == set(out_r["xset"]),
            f"per-core writes {sorted(out_k['xset'])} vs "
            f"{sorted(out_r['xset'])}")
    for k, (val, msk) in out_r["xset"].items():
        pairs += [(f"xset.{k}", out_k["xset"][k][0], val),
                  (f"xset.{k}.mask", out_k["xset"][k][1], msk)]
    for name, x, y in pairs:
        require(x.dtype == y.dtype and x.shape == y.shape,
                f"{name}: {x.dtype}{tuple(x.shape)} vs "
                f"{y.dtype}{tuple(y.shape)}")
        d = (x.cpu().to(torch.int64) - y.cpu().to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


def phase_kernel(dev) -> int:
    worst, cases = 0, 0
    for i, (name, groups) in enumerate(PROTO_CASES):
        proto = protocols.get(name)
        for j, (n, a) in enumerate(KERNEL_SHAPES):
            rng = np.random.default_rng([11, i, j])
            p = sim.SimParams(protocol=name, n_cores=n, n_addrs=a,
                              n_groups=groups)
            q_cap = proto.q_cap(p, n)
            bank0 = random_bank(proto, p, a, n, q_cap, rng)
            bank_k = convert.to_torch(bank0, dev)
            bank_r = convert.to_torch(bank0, dev)
            cyc = int(rng.integers(1000, 5000))
            cycles = cyc + 12            # some grants retire past it
            for _ in range(4):           # chained cycles
                inputs = random_step(n, a, cyc, rng)
                kw = step_kwargs(inputs, dev, cyc, p, n, a, q_cap, cycles)
                out_k = engine_step.fused_step(proto, p, bank_k, **kw)
                out_r = engine_step.fused_step_ref(proto, p, bank_r, **kw)
                torch.cuda.synchronize()
                err = compare(out_k, out_r)
                require(err == 0, f"{name} n={n} a={a} groups={groups}: "
                                  f"kernel differs from plain by {err}")
                worst = max(worst, err)
                bank_k, bank_r = out_k["bank"], out_r["bank"]
                cyc += 1
                cases += 1
    emit(phase="kernel", cases=cases, shapes=KERNEL_SHAPES,
         protocols=PROTO_CASES, max_abs_err=worst, equal=True)
    return worst


def result_diff(got: dict, want: dict) -> list:
    """Keys where two ``sim.simulate`` result dicts differ: key order,
    dtype, shape or any value."""
    if list(got) != list(want):
        return [f"keys {list(got)} != {list(want)}"]
    return [k for k, w in want.items()
            if got[k].dtype != w.dtype or got[k].shape != w.shape
            or not torch.equal(got[k], w)]


def result_err(got: dict, want: dict) -> float:
    """Largest absolute difference over the keys of two result dicts of
    equal layout (0.0 when every value is equal)."""
    return max((float((got[k].double() - w.double()).abs().max())
                for k, w in want.items() if w.numel()), default=0.0)


def run_case(p, dev, traced: bool = False) -> tuple:
    """The engine_run kernel against the plain loop on the card for one
    point, every key equal; returns the plain loop's engine_step
    launches (one per cycle, counted from 0), the largest absolute
    difference over the keys and the kernel's result.  ``traced``: both
    in the sweep's form of a skewed Zipf stream."""
    what = (f"{p.protocol} n={p.n_cores} a={p.n_addrs} {p.workload} "
            f"seed={p.seed} trace={p.record_trace} groups={p.n_groups} "
            f"topology={p.topology} skew={p.zipf_skew} traced={traced}")
    reset_launches()
    want = sim._simulate_plain(p, dev, traced=traced)
    torch.cuda.synchronize()
    plain = dict(LAUNCHES)
    require(plain["engine_step"] == p.cycles and plain["engine_run"] == 0,
            f"{what}: the plain loop made {plain['engine_step']} engine_step "
            f"and {plain['engine_run']} engine_run launches")
    got = engine_step.run_cuda_batch(
        [(p, protocols.get(p.protocol), workloads.get(p.workload).program(p),
          p.n_addrs)], dev, traced=traced)[0]
    torch.cuda.synchronize()
    require(LAUNCHES["engine_run"] == 1, f"{what}: no engine_run launch")
    bad = result_diff(got, want)
    require(not bad, f"{what}: kernel differs from the plain loop on {bad}")
    return plain["engine_step"], result_err(got, want), got


def phase_model_check(dev) -> dict:
    """The model checker's full gate (``repro_torch.analysis``: all eleven
    protocols, every configuration, the kill pass) with the engine_step
    kernel in the fused twin's place: each distinct delivery one launch
    of the one-candidate step on the card, its bank state, kind and
    per-core writes held to ``on_access`` on the host (``handler-mismatch``
    and every other rule).  0 findings, and states and transitions equal
    to the same gate with ``fused_access`` on the CPU."""
    t0 = time.perf_counter()
    cpu = {r.subject: r.stats for r in model_check.check_all()}
    cpu_s = time.perf_counter() - t0
    seam = model_check.HookDriver.fused_side
    model_check.HookDriver.fused_side = model_check.stepped(
        engine_step.fused_step, dev)
    reset_launches()
    t0 = time.perf_counter()
    try:
        reps = model_check.check_all()
    finally:
        model_check.HookDriver.fused_side = seam
    seconds = time.perf_counter() - t0
    launches = LAUNCHES["engine_step"]
    rows = {r.subject: dict(states=r.stats["states"],
                            transitions=r.stats["transitions"],
                            findings=len(r.findings)) for r in reps}
    emit(phase="model_check", protocols=rows,
         states=sum(r["states"] for r in rows.values()),
         transitions=sum(r["transitions"] for r in rows.values()),
         findings=sum(r["findings"] for r in rows.values()),
         engine_step_launches=launches, seconds=seconds,
         launches_per_s=launches / seconds, cpu_seconds=cpu_s)
    require(all(r.ok for r in reps), "model check with the engine_step "
                                     "kernel:\n" + fail_fast(reps, limit=10))
    for r in reps:
        want = cpu[r.subject]
        require((r.stats["states"], r.stats["transitions"])
                == (want["states"], want["transitions"]),
                f"model check {r.subject}: {r.stats['states']} states, "
                f"{r.stats['transitions']} transitions on the card against "
                f"{want['states']}, {want['transitions']} on the CPU")
    require(launches > 0 and LAUNCHES["engine_run"] == 0,
            f"model check launches: {dict(LAUNCHES)}")
    return dict(launches=launches, seconds=seconds)


def phase_run_kernel(dev) -> dict:
    """engine_run against the plain loop (``sim._simulate_plain``, whose
    bank side is the per-cycle engine_step kernel) on the card, for each
    PROTO_CASES entry at every KERNEL_SHAPES entry over RUN_KERNEL_CYCLES
    cycles (RUN_KERNEL_CYCLES_EARLIER for the protocols of earlier
    slices), untraced and with record_trace and 64 telemetry windows
    (uniform and Zipf streams in turn, seeds past the int32 range), plus
    the colibri_workers point and each PROTO_CASES entry at the
    LAYOUT_CASES."""
    params = []
    for i, (name, groups) in enumerate(PROTO_CASES):
        cycles = (RUN_KERNEL_CYCLES if name in HIER_PROTOS
                  else RUN_KERNEL_CYCLES_EARLIER)
        for j, (n, a) in enumerate(KERNEL_SHAPES):
            for traced in (False, True):
                params.append(sim.SimParams(
                    protocol=name, n_cores=n, n_addrs=a, n_groups=groups,
                    workload="zipf_histogram" if j % 2 else "rmw_loop",
                    zipf_skew=0, cycles=cycles,
                    seed=100 * i + j - (2**33 if traced else 0),
                    record_trace=traced, telemetry_windows=64 * traced))
        for j, (n, a) in enumerate(LAYOUT_CASES):
            params.append(sim.SimParams(
                protocol=name, n_cores=n, n_addrs=a, n_groups=groups,
                workload="zipf_histogram", zipf_skew=0,
                cycles=LAYOUT_CASE_CYCLES, seed=9 + 10 * i + j,
                record_trace=True, telemetry_windows=8))
    cfg, _ = GOLDEN_EXTRA["colibri_workers"]
    for traced in (False, True):
        params.append(sim.SimParams(
            **cfg, record_trace=traced, telemetry_windows=64 * traced))
    plain_launches, worst = 0, 0.0
    for p in params:
        launches, err, _ = run_case(p, dev)
        plain_launches += launches
        worst = max(worst, err)
    with own_program():
        programs = program_params()
        for p in programs:
            launches, err, _ = run_case(p, dev)
            plain_launches += launches
            worst = max(worst, err)
    topo = topo_zipf_params()
    for p, traced in topo:
        launches, err, _ = run_case(p, dev, traced)
        plain_launches += launches
        worst = max(worst, err)
    faults, recoveries, halts = fault_params(), 0, 0
    for p in faults:
        launches, err, got = run_case(p, dev)
        plain_launches += launches
        worst = max(worst, err)
        if p.faults == FaultPlan(**FAULT_KERNEL_PLAN):
            recoveries += int(got["recoveries"])
            halts += int(got["halt_cyc"]) >= 0
    require(recoveries > 0 and halts > 0,
            f"run_kernel faults: {recoveries} recoveries and {halts} halts "
            f"flagged under the mixed plan")
    reset_launches()                   # comparison runs: no path's count
    emit(phase="run_kernel",
         cases=len(params) + len(programs) + len(topo) + len(faults),
         program_cases=len(programs), topology_zipf_cases=len(topo),
         fault_cases=len(faults), fault_recoveries=recoveries,
         fault_halts=halts,
         shapes=KERNEL_SHAPES,
         layout_cases=LAYOUT_CASES, protocols=PROTO_CASES,
         program_workloads=PROGRAM_WORKLOADS + (OWN_PROGRAM,),
         cycles=RUN_KERNEL_CYCLES,
         cycles_earlier=RUN_KERNEL_CYCLES_EARLIER,
         layout_case_cycles=LAYOUT_CASE_CYCLES,
         plain_engine_step_launches=plain_launches, max_abs_err=worst,
         equal=True)
    return dict(cases=len(params) + len(programs) + len(topo) + len(faults),
                plain_launches=plain_launches, max_abs_err=worst)


def fault_params() -> list:
    """The run_kernel phase's cases of the fault instance: every protocol
    at 256 × TOPO_ADDRS over RUN_KERNEL_CYCLES under FAULT_KERNEL_PLAN;
    lrscwait and ticket_lock traced (64 windows) under FAULT_TRACED_PLAN;
    colibri_hier on cluster2 and ms_queue for colibri and lrsc under
    FAULT_KERNEL_PLAN; the LAYOUT_CASES (colibri, lrsc_lock) under it,
    sooner, over LAYOUT_CASE_CYCLES, traced."""
    def pt(**kw):
        kw.setdefault("n_cores", 256)
        kw.setdefault("cycles", RUN_KERNEL_CYCLES)
        kw.setdefault("faults", FaultPlan(**FAULT_KERNEL_PLAN))
        return sim.SimParams(**kw)
    out = [pt(protocol=pr, n_addrs=TOPO_ADDRS, seed=90 + i)
           for i, pr in enumerate(PROTOS)]
    out += [pt(protocol=pr, n_addrs=TOPO_ADDRS, seed=110 + i,
               record_trace=True, telemetry_windows=64,
               faults=FaultPlan(**FAULT_TRACED_PLAN))
            for i, pr in enumerate(("lrscwait", "ticket_lock"))]
    out.append(pt(protocol="colibri_hier", topology="cluster2",
                  clusters=TOPO_CLUSTERS, n_addrs=TOPO_ADDRS,
                  net_bw=TOPO_KERNEL_NET_BW, seed=120))
    out += [pt(protocol=pr, workload="ms_queue", seed=130 + i,
               **workloads.get("ms_queue").scenario)
            for i, pr in enumerate(("colibri", "lrsc"))]
    out += [pt(protocol=pr, n_cores=n, n_addrs=a, cycles=LAYOUT_CASE_CYCLES,
               seed=140 + j, record_trace=True, telemetry_windows=8,
               faults=FaultPlan(**dict(FAULT_KERNEL_PLAN, kill_cyc=5,
                                       bank_stall_cyc=10, progress_cyc=20)))
            for j, ((n, a), pr) in enumerate(zip(LAYOUT_CASES,
                                                 ("colibri", "lrsc_lock")))]
    return out


def topo_zipf_params() -> list:
    """The run_kernel phase's cases of the topology instance and the Zipf
    lookup, ``(SimParams, the sweep's form)`` each: every protocol on
    cluster2 and cluster3 at (TOPO_KERNEL_CORES, TOPO_ADDRS), traced on
    cluster3, TOPO_KERNEL_NET_BW so the levels' budgets turn requests
    away, on the skewed stream in turns; the other register layouts
    (TOPO_KERNEL_LAYOUTS) on cluster3 with Fig. 5 workers; and
    ZIPF_KERNEL_CASES on the flat topology, traced."""
    out = []
    for i, name in enumerate(PROTOS):
        for j, topo in enumerate(("cluster2", "cluster3")):
            traced = topo == "cluster3"
            out.append((sim.SimParams(
                protocol=name, topology=topo, clusters=TOPO_CLUSTERS * (j + 1),
                n_cores=TOPO_KERNEL_CORES, n_addrs=TOPO_ADDRS,
                net_bw=TOPO_KERNEL_NET_BW, workload="zipf_histogram",
                zipf_skew=(0, 200)[i % 2], cycles=RUN_KERNEL_CYCLES_EARLIER,
                seed=40 * i + j, record_trace=traced,
                telemetry_windows=64 * traced), i % 2 == 1))
    for j, (n, a) in enumerate(TOPO_KERNEL_LAYOUTS):
        out.append((sim.SimParams(
            protocol=("lrscwait", "colibri_hier")[j], topology="cluster3",
            clusters=8, n_cores=n, n_addrs=a, n_workers=n // 8, net_bw=48,
            cycles=LAYOUT_CASE_CYCLES, seed=60 + j, record_trace=True,
            telemetry_windows=8), False))
    for j, (name, bins, skew, traced) in enumerate(ZIPF_KERNEL_CASES):
        out.append((sim.SimParams(
            protocol=name, workload="zipf_histogram", zipf_skew=skew,
            n_cores=256, n_addrs=bins, cycles=RUN_KERNEL_CYCLES_EARLIER,
            seed=80 + j, record_trace=True, telemetry_windows=64), traced))
    return out


@contextlib.contextmanager
def own_program():
    """OWN_FIELDS registered as the workload OWN_PROGRAM for the length of
    the block."""
    from repro_torch.core.workloads import base, registry
    wl = base.Workload()
    wl.name, wl.min_addrs = OWN_PROGRAM, OWN_MIN_ADDRS
    wl.program = lambda p: base.Program(**OWN_FIELDS)
    registry.register(wl)
    try:
        yield
    finally:
        del registry._REGISTRY[OWN_PROGRAM]


def program_params() -> list:
    """The run_kernel phase's program cases: each PROGRAM_WORKLOADS entry
    for every protocol at its scenario and PROGRAM_CORES cores, untraced
    and traced (64 windows); OWN_PROGRAM (registered by the caller) for
    every protocol, traced; barrier_phases with 32 Fig. 5 workers for
    colibri and lrsc, untraced and traced; all at
    RUN_KERNEL_CYCLES_EARLIER cycles."""
    out = []
    for i, name in enumerate(PROTOS):
        for j, wl in enumerate(PROGRAM_WORKLOADS):
            for traced in (False, True):
                out.append(sim.SimParams(
                    protocol=name, workload=wl, n_cores=PROGRAM_CORES,
                    cycles=RUN_KERNEL_CYCLES_EARLIER,
                    seed=30 * i + 2 * j + traced - 2**32 * traced,
                    record_trace=traced, telemetry_windows=64 * traced,
                    **workloads.get(wl).scenario))
        out.append(sim.SimParams(
            protocol=name, workload=OWN_PROGRAM, n_cores=PROGRAM_CORES,
            n_addrs=3, zipf_skew=0, backoff=24,
            cycles=RUN_KERNEL_CYCLES_EARLIER, seed=700 + i,
            record_trace=True, telemetry_windows=64))
    for name in ("colibri", "lrsc"):
        for traced in (False, True):
            out.append(sim.SimParams(
                protocol=name, workload="barrier_phases",
                n_cores=PROGRAM_CORES, n_addrs=1, n_workers=32, net_bw=13,
                hol_block=16, cycles=RUN_KERNEL_CYCLES_EARLIER, seed=9,
                record_trace=traced, telemetry_windows=64 * traced))
    return out


def scatter_inputs(dev, t: int, bins: int, d: int, dtype: str, seed: int):
    """Seeded keys in [0, bins) and standard-normal values on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, bins, (t,), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((t, d), generator=g, device=dev)
    return keys, vals.to(getattr(torch, dtype))


def skewed_keys(t: int, bins: int, seed: int,
                exponent: float = 2.0) -> np.ndarray:
    """``t`` sorted int32 keys drawn (numpy, seeded) from a Zipf law
    over ``bins``: p(b) proportional to (b + 1)^-exponent."""
    p = 1.0 / np.arange(1, bins + 1) ** exponent
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(bins, size=t, p=p / p.sum())).astype(np.int32)


def scatter_check(keys, vals, bins: int, what: str) -> float:
    """The op (sort + commit kernel) against its plain version on one
    stream: float sums within ``SCATTER_TOL``, histograms exact (also
    against ``torch.bincount``), a second call's output bit for bit the
    first's, 1-D values the 2-D ones' column.  Returns the worst
    difference."""
    dtype = str(vals.dtype).removeprefix("torch.")
    t, d = vals.shape
    out = colibri_scatter.colibri_scatter_add(keys, vals, bins)
    again = colibri_scatter.colibri_scatter_add(keys, vals, bins)
    ref = colibri_scatter.scatter_add_ref(keys, vals, bins)
    hist = colibri_scatter.colibri_histogram(keys, bins)
    torch.cuda.synchronize()
    require(out.dtype == vals.dtype and tuple(out.shape) == (bins, d),
            f"{what}: output {out.dtype}{tuple(out.shape)}")
    require(torch.equal(out.view(torch.int16 if dtype == "bfloat16"
                                 else torch.int32),
                        again.view(torch.int16 if dtype == "bfloat16"
                                   else torch.int32)),
            f"{what}: two calls differ in their bits")
    rtol, atol = SCATTER_TOL[dtype]
    err = float((out.float() - ref.float()).abs().max())
    require(torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol),
            f"{what}: kernel differs from plain by {err}")
    kept = keys[(keys >= 0) & (keys < bins)]
    require(torch.equal(hist, colibri_scatter.histogram_ref(keys, bins))
            and torch.equal(hist, torch.bincount(
                kept, minlength=bins).int()),
            f"{what}: histogram differs")
    if d == 1:
        flat = colibri_scatter.colibri_scatter_add(keys, vals[:, 0], bins)
        require(torch.equal(flat, out[:, 0]), f"{what}: 1-D vals differ")
    return err


def phase_scatter_kernel(dev) -> dict:
    """The colibri_scatter op against its plain version at every
    ``SCATTER_SHAPES`` shape on uniform keys and with keys dropped at both
    ends (every 7th key set to ``bins``, every 11th to -1 or -3), on the
    skewed stream (``SCATTER_SKEW``), one key spanning the whole stream
    and T = 0."""
    worst = dict.fromkeys(SCATTER_TOL, 0.0)
    cases = 0
    for i, (t, bins, d, dtype) in enumerate(SCATTER_SHAPES):
        keys, vals = scatter_inputs(dev, t, bins, d, dtype, i)
        dropped = keys.clone()
        dropped[::7] = bins                      # out of range: dropped
        dropped[3::11] = -1
        dropped[5::11] = -3
        for k in (keys, dropped):
            err = scatter_check(k, vals, bins,
                                f"T={t} bins={bins} d={d} {dtype}")
            worst[dtype] = max(worst[dtype], err)
            cases += 1
    t, bins = SCATTER_SKEW
    g = torch.Generator(device=dev).manual_seed(41)
    vals = torch.randn((t, 1), generator=g, device=dev)
    extra = {"skewed": torch.from_numpy(skewed_keys(t, bins, seed=41)),
             "one_key": torch.full((t,), 17, dtype=torch.int32)}
    for name, keys in extra.items():
        err = scatter_check(keys.to(dev), vals, bins, f"{name} T={t}")
        worst["float32"] = max(worst["float32"], err)
        cases += 1
    for dtype in SCATTER_TOL:
        empty = torch.zeros((0, 3), device=dev, dtype=getattr(torch, dtype))
        scatter_check(torch.zeros(0, dtype=torch.int32, device=dev), empty,
                      5, f"T=0 {dtype}")
        cases += 1
    emit(phase="scatter_kernel", cases=cases, shapes=SCATTER_SHAPES,
         skewed=SCATTER_SKEW, max_abs_err=worst, tolerance=SCATTER_TOL,
         histograms_exact=True, deterministic=True, equal=True)
    return worst


def phase_exact(dev) -> None:
    h = torch.arange(1 << 24, dtype=torch.int64)
    bins = (1, 4, 16, 64, 256, 1024)
    for b in bins:
        cpu = zipf_index(h, b, 0)
        gpu = zipf_index(h.to(dev), b, 0).cpu()
        require(torch.equal(cpu, gpu), f"zipf_index differs at {b} bins")
    # hash inputs as the engine forms them (int64 holding the exact sum),
    # including values past the int32 range on both sides
    rng = np.random.default_rng(5)
    x = np.concatenate([
        np.arange(-(1 << 23), 1 << 23, dtype=np.int64),
        rng.integers(-(1 << 40), 1 << 40, 1 << 22),
        np.arange(2**31 - 4096, 2**31 + 4096, dtype=np.int64),
        np.arange(-(2**31) - 4096, -(2**31) + 4096, dtype=np.int64)])
    want = (x.astype(np.uint32) * np.uint32(2654435761)) >> np.uint32(8)
    xt = torch.from_numpy(x)
    got_cpu = sim._hash(xt).numpy()
    got_gpu = sim._hash(xt.to(dev)).cpu().numpy()
    require(np.array_equal(got_cpu, want.astype(np.int64)),
            "_hash on the CPU differs from uint32 arithmetic")
    require(np.array_equal(got_gpu, got_cpu), "_hash differs on the card")
    # the engine_run kernel's own device code (engine_probe_launch)
    xu = torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(dev)
    require(np.array_equal(probe(xu, 0).cpu().numpy(), got_cpu),
            "the kernel's _hash differs from the CPU's")
    require(np.array_equal(probe(xu, 1).cpu().numpy(), got_cpu % 32),
            "the kernel's backoff jitter differs from the CPU's")
    hu = h.to(torch.int32).to(dev)
    for b in bins + ZIPF_FMA_BINS:
        zipf = probe(hu, 2, ADDR_ZIPF, b, zipf_factors(b, 0)).cpu()
        require(torch.equal(zipf, zipf_index(h, b, 0)),
                f"the kernel's zipf stream differs at {b} bins")
        uni = probe(hu, 2, 0, b).cpu()
        require(torch.equal(uni, (h % b).to(torch.int32)),
                f"the kernel's uniform stream differs at {b} bins")
    # the skewed streams: the kernel's threshold lookup, and zipf_index's
    # on the card, against the CPU's on every hash
    for b, skew, traced in ZIPF_PROBES:
        want = zipf_index(h, b, skew, traced)
        thr = torch.from_numpy(zipf_thresholds(b, skew, traced)).to(dev)
        got = probe(hu, 2, ADDR_ZIPF, b, 0.0, thr).cpu()
        require(torch.equal(got, want), f"the kernel's zipf lookup differs "
                f"at {b} bins, skew {skew}, traced={traced}")
        require(torch.equal(zipf_index(h.to(dev), b, skew, traced).cpu(),
                            want), f"zipf_index differs on the card at {b} "
                f"bins, skew {skew}, traced={traced}")
    emit(phase="exact", zipf_bins=bins + ZIPF_FMA_BINS,
         zipf_skewed=ZIPF_PROBES, zipf_inputs=1 << 24,
         hash_inputs=int(x.size), kernel_probe=True, equal=True)


def probe(x: torch.Tensor, what: int, mode: int = 0, n_addrs: int = 1,
          zipf_c: float = 0.0, thr=None) -> torch.Tensor:
    """The engine_run kernel's device functions on the int32 card tensor
    ``x`` (read as uint32): ``what`` 0 is ``_hash``, 1 the backoff jitter,
    2 the address of hash ``x`` in address mode ``mode`` (a skewed Zipf
    stream: its thresholds ``thr``, an int32 card tensor)."""
    fn = _build.library("engine_step").engine_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_void_p]
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), x.numel(), what, mode, n_addrs, zipf_c,
             None if thr is None else thr.data_ptr(),
             0 if thr is None else thr.numel(),
             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"engine_probe launch: CUDA error {err}")
    torch.cuda.synchronize()
    return out


INT_KINDS = ("i", "u", "b")


def int_keys_equal(r_gpu, r_cpu) -> list:
    """Integer/bool keys where two result dicts differ (value or dtype)."""
    bad = []
    for k, v in r_cpu.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in INT_KINDS:
            w = r_gpu.get(k)
            if not (isinstance(w, np.ndarray) and w.dtype == v.dtype
                    and np.array_equal(w, v)):
                bad.append(k)
    return bad


def require_one_run(what: str) -> None:
    """The point since the last reset_launches was one engine_run launch
    and no per-cycle engine_step launch."""
    require(LAUNCHES["engine_run"] == 1 and LAUNCHES["engine_step"] == 0,
            f"{what}: {LAUNCHES['engine_run']} engine_run and "
            f"{LAUNCHES['engine_step']} engine_step launches")


def phase_golden() -> None:
    n_points = 0
    for name in GOLDEN_PROTOS:
        for i, cfg in enumerate(GOLDEN_CONFIGS):
            reset_launches()
            r = run(Spec(protocol=name, **cfg))
            require_one_run(f"{name}/{i}")
            want = GOLDEN[f"{name}/{i}"]
            got = observe(r.stats)
            require({k: got[k] for k in want} == want,
                    f"{name}/{i}: {got} != {want}")
            n_points += 1
            if i == 0:
                cpu = run(Spec(protocol=name, **cfg), device="cpu")
                bad = int_keys_equal(r.stats, cpu.stats)
                require(not bad, f"{name}/0: card and CPU differ on {bad}")
    for key, (cfg, want) in GOLDEN_EXTRA.items():
        cfg = dict(cfg)
        proto = cfg.pop("protocol", "lrscwait")
        reset_launches()
        r = run(Spec(protocol=proto, **cfg))
        require_one_run(key)
        got = observe(r.stats)
        require({k: got[k] for k in want} == want, f"{key}: {got} != {want}")
        n_points += 1
    # the protocols without golden values: each config on the card
    # against the port's CPU run, every integer key
    for name in HIER_PROTOS:
        for i, cfg in enumerate(GOLDEN_CONFIGS):
            reset_launches()
            r = run(Spec(protocol=name, **cfg))
            require_one_run(f"{name}/{i}")
            require(int(r.polls) == 0, f"{name}/{i}: {int(r.polls)} polls")
            cpu = run(Spec(protocol=name, **cfg), device="cpu")
            bad = int_keys_equal(r.stats, cpu.stats)
            require(not bad, f"{name}/{i}: card and CPU differ on {bad}")
            n_points += 1
    hier = hier_invariants()
    emit(phase="golden", points=n_points, protocols=GOLDEN_PROTOS,
         cpu_points=len(GOLDEN_PROTOS) + len(HIER_PROTOS)
         * len(GOLDEN_CONFIGS), cpu_protocols=HIER_PROTOS,
         colibri_hier_invariants=hier, equal=True)


def hier_invariants() -> dict:
    """The reference's ``test_colibri_hier_*`` invariants
    (``tests/test_protocols.py``) on the card, each run one engine_run
    launch: polling-free with round-robin fairness across groups (ops
    span at most 3), at least 0.8 of flat colibri's throughput at 1 and
    16 bins, and progress with no poll at 1, 2 and 8 groups."""
    def one(**kw):
        reset_launches()
        r = run(Spec(n_cores=64, **kw))
        require_one_run(f"invariant {kw}")
        return r
    r = one(protocol="colibri_hier", n_addrs=1, cycles=8000)
    span = int(r.stats["ops"].max()) - int(r.stats["ops"].min())
    require(int(r.polls) == 0 and int(r.stats["sleep_cyc"]) > 0
            and span <= 3 and int(r.stats["ops"].sum()) > 0,
            f"colibri_hier polling-free and fair: polls {int(r.polls)}, "
            f"span {span}")
    ratio = {}
    for bins in (1, 16):
        hier = one(protocol="colibri_hier", n_addrs=bins, cycles=8000)
        flat = one(protocol="colibri", n_addrs=bins, cycles=8000)
        ratio[bins] = hier.throughput / flat.throughput
        require(hier.throughput >= 0.8 * flat.throughput
                and int(hier.polls) == 0,
                f"colibri_hier at {bins} bins: {hier.throughput} against "
                f"colibri's {flat.throughput}")
    for g in (1, 2, 8):
        r = one(protocol="colibri_hier", n_groups=g, n_addrs=2, cycles=5000)
        require(int(r.polls) == 0 and int(r.stats["ops"].sum()) > 0,
                f"colibri_hier at {g} groups: polls {int(r.polls)}")
    return dict(ops_span=span, over_flat_colibri=ratio)


def time_launches(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls (CUDA
    events): the rate at which the host can issue it."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


#: rows the profiler records beside the device's work (CUPTI's own
#: buffer requests and lazy module loading, up to milliseconds each):
#: not device time
NOT_DEVICE_WORK = ("Activity Buffer Request", "Lazy Function Loading")


def device_rows(prof) -> list:
    """(name, count, device µs) of every device activity (kernels,
    memsets, copies) a ``torch.profiler`` run recorded.  Host-side ranges
    that carry their children's device time (``aten::`` ops, autograd
    nodes such as ``MmBackward0``, an autograd Function's own range) are
    not device activities: counting them would count a kernel twice."""
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0)
        if dt and ev.key and ev.key not in NOT_DEVICE_WORK \
                and getattr(ev, "device_type", None) != DeviceType.CPU \
                and not ev.key.startswith(("aten::", "cuda")):
            rows.append((ev.key, ev.count, dt))
    rows.sort(key=lambda r: -r[2])
    return rows


def device_ms(fn, reps: int, name: str = ""):
    """Device time per call of ``fn`` from ``torch.profiler`` over
    ``reps`` calls: for each device activity, its mean recorded duration
    times the number of times one call launches it.  Every call launches
    the same activities, ``ceil(count / reps)`` times each: the profiler
    can lose records (an H100 run lost 1-80 % of some kernels' records
    after earlier profiles in the same process), so a row's count may
    fall short of a multiple of ``reps``; the mean over the records kept
    is the same, as every call runs on the same inputs.  Lost records
    are reported (a ``device_ms_lost_records`` line).  A profile that
    recorded no device activity is taken again, up to three times; after
    many profiles in one process an H100 run recorded none at all, and
    then the time is taken with CUDA events around ``reps`` back-to-back
    calls instead (the host's issue included; a ``device_ms_by_events``
    line says so).  With ``name``, only the activities whose name holds
    it count."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in device_rows(prof) if name in r[0]]
        if not rows:
            continue
        per_call = [(-(-count // reps), count, us) for _, count, us in rows]
        lost = sum(k * reps - count for k, count, _ in per_call)
        if lost:
            emit(phase="device_ms_lost_records", reps=reps, lost=lost,
                 rows=[(name[:70], count) for name, count, _ in rows[:8]])
        return sum(us / count * k for k, count, us in per_call) / 1e3
    ms = time_launches(fn, reps)
    emit(phase="device_ms_by_events", reps=reps, name=name, ms=ms)
    return ms


#: bank-state lanes the protocol update reads at a bank with a request
#: (``wake_tmr`` and ``qbuf`` are only written)
READ_LANES = ("resv_core", "resv_valid", "qhead", "qlen")


def step_bytes(n: int, a: int, bank_in: dict, out: dict) -> int:
    """Bytes one step must move on these inputs, from the plain version's
    result ``out`` on the bank state ``bank_in``: ``cand_cyc`` and
    ``addr`` read once (``rot`` is ``(iota + shift) % n``, so it need
    not be read); at each bank with a request, the winner's ``phase``
    and ``acq_start`` and the bank's ``READ_LANES``; the bank-state
    elements that change; the four (a,) outputs and the 67 stat words,
    written once."""
    n_req = int(out["valid"].sum())
    lanes = sum(bank_in[k].element_size() for k in READ_LANES
                if k in bank_in)
    changed = sum(int((out["bank"][k] != v).sum()) * v.element_size()
                  for k, v in bank_in.items())
    return 8 * n + n_req * (8 + lanes) + changed + 13 * a + 4 * 67


def time_kernel(dev, name: str, n: int, a: int) -> dict:
    """Per-launch time of the kernel and of the plain version at the
    main path's shape, from a seeded random state."""
    proto = protocols.get(name)
    rng = np.random.default_rng(3)
    p = sim.SimParams(protocol=name, n_cores=n, n_addrs=a)
    q_cap = proto.q_cap(p, n)
    bank = convert.to_torch(random_bank(proto, p, a, n, q_cap, rng), dev)
    kw = step_kwargs(random_step(n, a, 5000, rng), dev, 5000, p, n, a,
                     q_cap, p.cycles)
    n_bytes = step_bytes(n, a, bank,
                         engine_step.fused_step_ref(proto, p, bank, **kw))
    launches = LAUNCHES["engine_step"]

    def kern():
        engine_step.fused_step(proto, p, bank, **kw)

    def plain():
        engine_step.fused_step_ref(proto, p, bank, **kw)

    out = dict(protocol=name, n=n, a=a,
               ms=device_ms(kern, 500), plain_ms=device_ms(plain, 100),
               call_ms=time_launches(kern, 2000),
               plain_call_ms=time_launches(plain, 300),
               bound_bytes=n_bytes,
               bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3)
    LAUNCHES["engine_step"] = launches         # timing runs are not counted
    return out


def barrier_floor_ms(threads: int, cycles: int, per_cycle: int,
                     blocks: int = 1) -> float:
    """Device ms of engine_barrier_kernel: a grid of ``blocks`` blocks of
    ``threads``, each ``cycles`` cycles of ``per_cycle`` barriers and no
    other work (CUDA events, one launch after a warm one)."""
    fn = _build.library("engine_step").engine_barrier_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    sink = torch.zeros(blocks, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    require(fn(blocks, threads, cycles, per_cycle, sink.data_ptr(),
               stream) == 0, "engine_barrier launch failed")  # warm
    t0.record()
    require(fn(blocks, threads, cycles, per_cycle, sink.data_ptr(),
               stream) == 0, "engine_barrier launch failed")
    t1.record()
    torch.cuda.synchronize()
    require(bool((sink == cycles).all()), "engine_barrier ran short")
    return t0.elapsed_time(t1)


def run_block(protocol: str, n: int, faults: bool = False) -> tuple:
    """engine_run's block for a run of ``n`` cores: (threads, block
    barriers per simulated cycle: 4 for the queue protocols, 2 for amo,
    lrsc and the spin locks; one more on the fault instance, with a
    plan, and one more again in a cycle that may kill a holder)."""
    threads = _build.library("engine_step").engine_run_threads(n)
    return threads, ((4 if protocols.get(protocol).uses_queue else 2)
                     + int(faults))


def run_bound(p) -> dict:
    """The least time the card could take for one engine run: the bytes
    it must move (the initial bank state read once, every result tensor
    written once) over 3.35 TB/s, beside the serial floor of its chain
    of cycles, ``barrier_floor_ms`` at the kernel's block size and
    barriers per cycle (``run_block``)."""
    proto = protocols.get(p.protocol)
    out = sim.simulate(p, "cuda")
    bank = proto.init_bank_state(p, p.n_addrs, p.n_cores,
                                 proto.q_cap(p, p.n_cores), "cuda")
    n_bytes = sum(t.numel() * t.element_size()
                  for t in list(out.values()) + list(bank.values()))
    threads, per_cycle = run_block(p.protocol, p.n_cores, p.faults.enabled)
    return dict(bound_bytes=n_bytes,
                bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                barriers_per_cycle=per_cycle, threads=threads,
                barrier_floor_ms=barrier_floor_ms(threads, p.cycles,
                                                  per_cycle))


def time_run(spec, plain: bool) -> dict:
    """One engine run at a main-path point: the engine_run kernel's
    device time (profiler, the kernel alone), the bounds and the barrier
    floor; with ``plain``, the plain loop's time too (CUDA events around
    one run of ``sim._simulate_plain`` on the card: it is host-bound, so
    its time is its wall), and its result must equal the kernel's on
    every key."""
    p = spec.to_params()
    launches = dict(LAUNCHES)
    ms = device_ms(lambda: sim.simulate(p, "cuda"), 5, name="engine_run")
    plain_ms, err = None, None
    if plain:
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0.record()
        want = sim._simulate_plain(p, "cuda")
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        got = sim.simulate(p, "cuda")
        bad = result_diff(got, want)
        require(not bad, f"{p.protocol}/{p.n_cores}/{p.n_addrs} at "
                f"{p.cycles} cycles: kernel differs from the plain loop "
                f"on {bad}")
        err = result_err(got, want)
    rec = dict(protocol=p.protocol, workload=p.workload, n=p.n_cores,
               a=p.n_addrs, cycles=p.cycles, ms=ms,
               us_per_cycle=ms / p.cycles * 1e3,
               plain_ms=plain_ms, max_abs_err=err, library_ms=None,
               **run_bound(p))
    LAUNCHES.update(launches)                 # timing runs are not counted
    return rec


def phase_main() -> dict:
    points, by, total, step_total = [], {}, 0, 0
    for name, n, bins in FULL_WIDTH_POINTS:
        spec = full_width_spec(name, n, bins)
        reset_launches()
        t0 = time.perf_counter()
        r = run(spec)
        wall = time.perf_counter() - t0
        launches = LAUNCHES["engine_run"]
        total += launches
        step_total += LAUNCHES["engine_step"]
        cycles = spec.costs.cycles
        got = full_width_summary(r.stats)
        want = FULL_WIDTH_REF[f"{name}/{n}/{bins}"]
        require(got == want, f"{name}/{n}/{bins}: {got} != {want}")
        require_one_run(f"{name}/{n}/{bins}")
        by[(name, n, bins)] = r
        rec = dict(protocol=name, cores=n, bins=bins, cycles=cycles,
                   launches=launches, wall_s=wall,
                   core_cycles_per_s=n * cycles / wall,
                   ms_per_cycle=wall / cycles * 1e3, **got)
        points.append(rec)
        emit(phase="main_point", equal=True, **rec)
    ratio = (by[("colibri", 256, 1)].throughput
             / by[("lrsc", 256, 1)].throughput)
    emit(phase="main", points=len(points), launches=total,
         engine_step_launches=step_total,
         colibri_over_lrsc_1bin=ratio, equal=True)
    return dict(launches=total, step_launches=step_total, points=points)


def phase_trace(main_points: list) -> dict:
    """The trace path at full width, each point beside its untraced run
    of the main phase (same call, same card; per cycle, as the main
    points run FULL_WIDTH_CYCLES and the traced ones TRACE_CYCLES)."""
    untraced = {(r["protocol"], r["cores"], r["bins"]): r["ms_per_cycle"]
                for r in main_points}
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    total = dict.fromkeys(LAUNCHES, 0)
    by, streams = {}, {}
    for name, n, bins in TRACE_POINTS:
        key = f"{name}/{n}/{bins}"
        spec = trace_spec(name, n, bins)
        reset_launches()
        t0 = time.perf_counter()
        r = run(spec)
        wall = time.perf_counter() - t0
        hist = metrics.trace_latency_hist(r.stats)
        launches = dict(LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        cycles = spec.costs.cycles
        require_one_run(key)
        require(launches["colibri_scatter"] == 1,
                f"{key}: {launches['colibri_scatter']} colibri_scatter "
                f"launches for one trace_latency_hist")
        doc = None
        if (name, n, bins) in PERFETTO_HASHED:
            path = out_dir / f"trace_{name}_{n}_{bins}.json"
            doc = Path(perfetto.export(r, str(path))).read_bytes()
        got = trace_record(r.stats, r.events(), hist, doc)
        want = TRACE_REF[key]
        require(got == want, f"{key}: differs from the reference on "
                f"{[k for k in want if got.get(k) != want[k]]}")
        by[(name, bins)] = got
        streams[key] = got["trace_latency_hist"]
        base = untraced[(name, n, bins)]
        bound = run_bound(spec.to_params())     # not counted: the phase's
        LAUNCHES.update(launches)               # counts were read above
        emit(phase="trace_point", equal=True, protocol=name, cores=n,
             bins=bins, cycles=cycles, launches=launches, wall_s=wall,
             ms_per_cycle=wall / cycles * 1e3, untraced_ms_per_cycle=base,
             overhead_ms_per_cycle=wall / cycles * 1e3 - base,
             bound_bytes=bound["bound_bytes"], bound_ms=bound["bound_ms"],
             polls=got["polls"], lat_p50=got["lat_p50"],
             lat_p95=got["lat_p95"], spans=got["spans"],
             perfetto_bytes=None if doc is None else len(doc))
    bin_counts = sorted({b for _, _, b in TRACE_POINTS})
    for bins in bin_counts:
        col, lr = by[("colibri", bins)], by[("lrsc", bins)]
        require(col["spans"]["BACKOFF"] == 0 and col["polls"] == 0,
                f"colibri at {bins} bins: {col['spans']['BACKOFF']} "
                f"BACKOFF spans, {col['polls']} polls")
        require(lr["spans"]["BACKOFF"] > 0,
                f"lrsc at {bins} bins shows no BACKOFF span")
    emit(phase="trace", points=len(TRACE_POINTS), launches=total,
         lrsc_backoff_spans={b: by[("lrsc", b)]["spans"]["BACKOFF"]
                             for b in bin_counts},
         colibri_backoff_spans=0, equal=True)
    return dict(launches=total, streams=streams)


def profile_run(spec) -> dict:
    """Device activity of one run of ``spec`` under ``torch.profiler``,
    after a warm run and an unprofiled timed run.  A profile that kept no
    record of the engine_run kernel (the profiler can lose records: see
    ``device_ms``) is taken again, up to three times, and then reported
    with its shares as ``None`` (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    cycles = spec.costs.cycles
    launches = dict(LAUNCHES)
    run(spec)                                          # warm
    t0 = time.perf_counter()
    run(spec)
    wall = time.perf_counter() - t0
    for taken in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(spec)
            wall_prof = time.perf_counter() - t0
        rows = device_rows(prof)
        kern = [r for r in rows if "engine_run" in r[0]]
        if kern:
            break
    LAUNCHES.update(launches)                  # not a path's counted run
    busy = sum(r[2] for r in rows)
    kern_us = sum(r[2] for r in kern)
    return dict(cycles=cycles, wall_s=wall, wall_s_profiled=wall_prof,
                ms_per_cycle=wall / cycles * 1e3, profiles_taken=taken,
                device_busy_us=busy if kern else None,
                device_busy_share=busy / 1e6 / wall if kern else None,
                device_activities_per_cycle=sum(r[1] for r in rows) / cycles,
                engine_run_us=kern_us,
                engine_run_launches=sum(r[1] for r in kern),
                engine_run_share_of_busy=kern_us / busy if kern else None,
                top=[dict(kernel=k[:80], count=c, us=t)
                     for k, c, t in rows[:12]])


def phase_profile() -> None:
    """Device time by kernel over a whole run of the 256-core colibri
    point at one bin (the main path's FULL_WIDTH_CYCLES, untraced) and of
    its traced point (TRACE_CYCLES, 64 telemetry windows): the card's
    busy share of the run's wall, and the engine_run kernel's share of
    the busy time."""
    emit(phase="profile", **profile_run(full_width_spec("colibri", 256, 1)))
    emit(phase="profile_traced", **profile_run(trace_spec("colibri", 256, 1)))


def sweep_fig3_specs() -> list:
    """The Fig. 3 Study's points, and the 1024-core colibri point."""
    specs = [full_width_spec(proto, 256, bins).replace(q_slots=q)
             for proto, q in SWEEP_LINES for bins in SWEEP_BINS]
    return specs + [full_width_spec("colibri", 1024, 1)]


def sweep_mixed_specs() -> list:
    return [Spec(workload="zipf_histogram", zipf_skew=0, n_cores=256,
                 cycles=FULL_WIDTH_CYCLES).replace(**kw)
            for kw in SWEEP_MIXED]


def swept_diff(swept: dict, one: dict, p) -> list:
    """Keys where a swept point differs from its single run
    (``single_run``): every key of the single run, bank arrays on their
    live rows and the padded rows past them at the protocol's initial
    bank state; where the point's sweep stream differs
    (``sweep_form_differs``), its single run is a one-point Study, padded
    as the point is, and every key must be equal whole."""
    from repro_torch.core.sweep import _bucket_a
    if list(swept) != list(one):
        return [f"keys {list(swept)} != {list(one)}"]
    if sweep_form_differs(p):
        return [k for k, w in one.items()
                if np.asarray(swept[k]).dtype != np.asarray(w).dtype
                or not np.array_equal(swept[k], w, equal_nan=np.asarray(
                    w).dtype.kind == "f")]
    bucket = _bucket_a(p.n_addrs)
    proto = protocols.get(p.protocol)
    init = convert.to_numpy(proto.init_bank_state(
        p, bucket, p.n_cores, proto.q_cap(p, p.n_cores), "cpu"))
    bad = []
    for k, w in one.items():
        g, w = np.asarray(swept[k]), np.asarray(w)
        if k in BANK_AXIS:
            ax = BANK_AXIS[k]
            init_k = init.get(k)
            if ax == 0:                  # one row a bank, whatever its rows
                rows = w.shape[0] // p.n_addrs
                if g.shape[0] != bucket * rows:
                    bad.append(f"{k} (padding)")
                    continue
                g, w = g.reshape((bucket, -1)), w.reshape((p.n_addrs, -1))
                if init_k is not None:
                    init_k = init_k.reshape((bucket, -1))
            pad = np.take(g, range(p.n_addrs, bucket), axis=ax)
            want_pad = (np.take(init_k, range(p.n_addrs, bucket), axis=ax)
                        if init_k is not None else np.zeros_like(pad))
            if g.shape[ax] != bucket or not np.array_equal(pad, want_pad):
                bad.append(f"{k} (padding)")
                continue
            g = np.take(g, range(p.n_addrs), axis=ax)
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(
                g, w, equal_nan=g.dtype.kind == "f"):
            bad.append(k)
    return bad


def sweep_form_differs(p) -> bool:
    """Whether point ``p`` has a skewed Zipf stream whose sweep form (a
    Study's) differs from its single run's (``zipf_index``'s ``traced``)."""
    if ADDR_ZIPF not in workloads.get(p.workload).program(p).addr_mode \
            or p.zipf_skew == 0 or p.n_addrs < 2:
        return False
    return not np.array_equal(zipf_thresholds(p.n_addrs, p.zipf_skew, False),
                              zipf_thresholds(p.n_addrs, p.zipf_skew, True))


def single_run(spec):
    """A Study point's own single run, one launch: ``run(spec)``, or,
    where its stream's sweep form differs from a single run's
    (``sweep_form_differs``), a one-point Study, the sweep's form."""
    from repro_torch.sync import Study
    if not sweep_form_differs(spec.to_params()):
        return run(spec)
    return Study.from_specs([spec]).run()[0]


def sweep_check(name: str, specs: list, launches_want: int) -> dict:
    """One Study over ``specs`` on the card: its launches, then every
    point against its own single run (``single_run``, one launch each),
    bit for bit.  Returns the Study's results and walls beside the single
    runs'."""
    from repro_torch import obs
    from repro_torch.sync import Study
    study = Study.from_specs(specs)
    reset_launches()
    t0 = time.perf_counter()
    with obs.collect() as report:
        got = study.run()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    require(launches["engine_run"] == launches_want
            and launches["engine_step"] == 0,
            f"sweep {name}: {launches['engine_run']} engine_run and "
            f"{launches['engine_step']} engine_step launches, want "
            f"{launches_want} and 0")
    require(report.n_chunks == launches_want
            and report.n_points == len(specs),
            f"sweep {name}: report {report.summary()}")
    singles = []
    for spec, r in zip(specs, got):
        key = (f"{spec.protocol.name}/q{spec.protocol.q_slots}/"
               f"{spec.topology.n_cores}/{spec.topology.n_addrs}")
        require(r.ok, f"sweep {name} {key}: error record {r.error}")
        reset_launches()
        t1 = time.perf_counter()
        one = single_run(spec)
        singles.append(time.perf_counter() - t1)
        require_one_run(f"sweep {name} {key} single")
        bad = swept_diff(r.stats, one.stats, spec.to_params())
        require(not bad, f"sweep {name} {key}: differs from its single "
                         f"run on {bad}")
    LAUNCHES.update(launches)
    return dict(results=got, wall_s=wall, single_wall_s=singles,
                launches=launches["engine_run"], report=report.to_dict())


def time_batch(b: int) -> dict:
    """B seeds of colibri 256 x 1 at FULL_WIDTH_CYCLES in one launch:
    the card's time from the launch's first copy to the end of the
    kernel (CUDA events; the host has packed the launch before the first
    event), the host wall of the whole call, the barrier-only floor of a
    grid of B blocks and the byte bound, B times one run's; best of 3."""
    base = full_width_spec("colibri", 256, 1).to_params()
    pts = [dataclasses.replace(base, seed=s) for s in range(b)]
    launches = dict(LAUNCHES)
    sim.simulate_batch(pts, "cuda")                           # warm
    torch.cuda.synchronize()
    walls, card = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        sim.simulate_batch(pts, "cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sim.simulate_batch(pts, "cuda", started=e0)
        e1.record()
        torch.cuda.synchronize()
        card.append(e0.elapsed_time(e1))
    threads, per_cycle = run_block("colibri", 256)
    one = run_bound(base)
    LAUNCHES.update(launches)                 # timing runs are not counted
    floor = barrier_floor_ms(threads, base.cycles, per_cycle, blocks=b)
    ms, wall_ms = min(card), min(walls) * 1e3
    return dict(b=b, ms=ms, ms_per_point=ms / b, wall_ms=wall_ms,
                wall_ms_per_point=wall_ms / b,
                us_per_cycle=ms / base.cycles * 1e3, ms_turns=card,
                barrier_floor_ms=floor, bound_bytes=b * one["bound_bytes"],
                bound_ms=b * one["bound_ms"])


def occupancy(n: int, a: int, variant: int = 0) -> dict:
    """What the card gives engine_run blocks of ``n`` cores and ``a``
    banks on the kernel's instance ``variant`` (``es_kernel.INSTANCE_*``:
    without the two-level queues' and nb_feb's branches, with them, with
    them and the program code): blocks resident per SM, registers and
    local bytes a thread."""
    lib = _build.library("engine_step")
    lib.engine_run_occupancy.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_void_p]
    lib.engine_run_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.engine_run_smem_bytes.restype = ctypes.c_longlong
    smem = lib.engine_run_smem_bytes(n, a)
    out = (ctypes.c_int * 4)()
    require(lib.engine_run_occupancy(n, smem, variant, out) == 0,
            "engine_run_occupancy failed")
    return dict(n=n, a=a, variant=variant, smem=smem, blocks_per_sm=out[0],
                registers=out[1], threads=out[2], local_bytes=out[3],
                sms=torch.cuda.get_device_properties(0).multi_processor_count)


def phase_sweep() -> dict:
    """The batched sweep on the card: the Fig. 3 Study (30 uniform
    points and the 1024-core colibri point, 2 launches) and the mixed
    grid (1 launch), every point bit for bit equal to its single run,
    every Result ok, the full-width points equal to FULL_WIDTH_REF; then
    the Study's wall against its single runs', its busy share, ms per
    launch and per point at each SWEEP_B beside the grid's barrier floor
    and byte bound, and the blocks resident per SM."""
    fig3 = sweep_check("fig3", sweep_fig3_specs(), SWEEP_FIG3_LAUNCHES)
    by = {(r.spec.protocol.name, r.spec.protocol.q_slots,
           r.spec.topology.n_cores, r.spec.topology.n_addrs): r
          for r in fig3["results"]}
    for name, n, bins in FULL_WIDTH_POINTS:
        got = full_width_summary(by[(name, 256, n, bins)].stats)
        want = FULL_WIDTH_REF[f"{name}/{n}/{bins}"]
        require(got == want, f"sweep {name}/{n}/{bins}: {got} != {want}")
    mixed = sweep_check("mixed", sweep_mixed_specs(), 1)
    emit(phase="sweep_check", fig3_points=len(fig3["results"]),
         fig3_launches=fig3["launches"], mixed_points=len(SWEEP_MIXED),
         mixed_launches=mixed["launches"],
         full_width_ref_points=len(FULL_WIDTH_POINTS), equal=True,
         fig3_report=fig3["report"])

    from repro_torch import obs
    from repro_torch.sync import Study
    from torch.profiler import ProfilerActivity, profile
    study = Study.from_specs(sweep_fig3_specs())
    launches = dict(LAUNCHES)
    walls, card = [], []
    for _ in range(3):
        with obs.collect() as report:
            t0 = time.perf_counter()
            study.run()
            walls.append(time.perf_counter() - t0)
        card.append(report.to_dict())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        study.run()
        wall_prof = time.perf_counter() - t0
    LAUNCHES.update(launches)                 # timing runs are not counted
    rows = device_rows(prof)
    busy = sum(r[2] for r in rows)
    kern = [r for r in rows if "engine_run" in r[0]]
    single = sum(fig3["single_wall_s"])
    best = min(range(len(walls)), key=walls.__getitem__)
    fig3_time = dict(
        points=len(fig3["results"]), launches=SWEEP_FIG3_LAUNCHES,
        study_wall_s=fig3["wall_s"], study_wall_s_repeat=walls,
        single_walls_sum_s=single,
        single_wall_max_s=max(fig3["single_wall_s"]),
        single_walls_s=fig3["single_wall_s"],
        speedup=single / walls[best],
        chunk_execute_s=[c["execute_s"] for c in card[best]["chunks"]],
        device_busy_share=card[best]["execute_s"] / walls[best],
        wall_s_profiled=wall_prof, profiler_busy_us=busy,
        profiler_busy_share=busy / 1e6 / wall_prof,
        profiler_engine_run_us=sum(r[2] for r in kern),
        profiler_engine_run_launches=sum(r[1] for r in kern),
        top=[dict(kernel=k[:80], count=c, us=t) for k, c, t in rows[:8]])
    emit(phase="sweep_fig3_time", **fig3_time)
    batches = [time_batch(b) for b in SWEEP_B]
    emit(phase="sweep_batch_time", batches=batches)
    # one shape per instance of the kernel: 256 threads, 1 024 threads,
    # two cores a thread, cores in device memory
    occ = [occupancy(n, 1) for n in (256, 1024, 2048, 2100)]
    emit(phase="sweep_occupancy", shapes=occ)
    return dict(fig3_launches=fig3["launches"],
                mixed_launches=mixed["launches"], fig3=fig3_time,
                batches=batches, occupancy=occ)


def study_time(specs: list, chk: dict) -> dict:
    """A Study over ``specs`` run 3 more times on the card: its best wall,
    the chunks' card time (CUDA events, ``RunReport``: from the host's
    packing of each launch to the end of its copy back), ms per launch,
    the speedup over the points' single runs (``sweep_check``'s ``chk``)
    and the busy share (card over wall); the timing runs' launches are
    not counted."""
    from repro_torch import obs
    from repro_torch.sync import Study
    study = Study.from_specs(specs)
    launches = dict(LAUNCHES)
    walls, card, per_launch = [], [], []
    for _ in range(3):
        with obs.collect() as report:
            t0 = time.perf_counter()
            study.run()
            walls.append(time.perf_counter() - t0)
        d = report.to_dict()
        card.append(d["execute_s"])
        per_launch.append([c["execute_s"] * 1e3 for c in d["chunks"]])
    LAUNCHES.update(launches)                 # timing runs are not counted
    best = min(range(len(walls)), key=walls.__getitem__)
    single = sum(chk["single_wall_s"])
    return dict(points=len(specs), launches=chk["launches"],
                study_wall_s=walls[best], study_wall_s_repeat=walls,
                card_ms=card[best] * 1e3,
                card_ms_repeat=[c * 1e3 for c in card],
                card_ms_per_launch=per_launch[best],
                single_walls_sum_s=single,
                single_wall_max_s=max(chk["single_wall_s"]),
                speedup=single / walls[best],
                device_busy_share=card[best] / walls[best])


def fig4_specs() -> list:
    """Fig. 4's points (``benchmarks/bench_locks.py``): FIG4_LOCKS ×
    SWEEP_BINS at 256 cores and FIG4_CYCLES, the locks with the paper's
    fixed 128-cycle backoff."""
    return [Spec(protocol=pr, n_addrs=bins, cycles=FIG4_CYCLES,
                 **(dict(backoff=128, backoff_exp=1)
                    if pr.endswith("lock") else {}))
            for pr in FIG4_LOCKS for bins in SWEEP_BINS]


def phase_fig4() -> dict:
    """Fig. 4 on the card as one Study of ONE engine_run launch (30
    points of one core count), every point bit for bit equal to its
    single run; the figure's rows (updates per cycle and Jain fairness
    per protocol and bin), the launch's card time (CUDA events) and the
    Study's wall against the 30 single runs, the busy share."""
    specs = fig4_specs()
    chk = sweep_check("fig4", specs, 1)
    rows = {}
    for r in chk["results"]:
        rows.setdefault(r.spec.protocol.name, {})[r.spec.topology.n_addrs] \
            = dict(updates_per_cycle=r.throughput,
                   jain_fairness=r.jain_fairness, polls=r.polls)
    t = {(pr, b): rows[pr][b]["updates_per_cycle"]
         for pr in FIG4_LOCKS for b in SWEEP_BINS}
    emit(phase="fig4_rows", launches=chk["launches"], points=len(specs),
         cycles=FIG4_CYCLES, equal=True, rows=rows,
         colibri_over_amo_lock_1bin=t[("colibri", 1)] / t[("amo_lock", 1)],
         colibri_over_mwait_lock_1bin=(t[("colibri", 1)]
                                       / t[("mwait_lock", 1)]),
         colibri_best_everywhere=all(
             t[("colibri", b)] >= max(t[(pr, b)] for pr in FIG4_LOCKS[1:])
             * 0.99 for b in SWEEP_BINS))
    rec = study_time(specs, chk)
    emit(phase="fig4_time", **rec)
    return rec


def hier_specs() -> list:
    """The hier phase's points: HIER_LINES × SWEEP_BINS, 256 cores,
    HIER_CYCLES, the Fig. 3 histogram's uniform bins (``zipf_histogram``
    at skew 0)."""
    return [Spec(protocol=pr, n_groups=g, workload="zipf_histogram",
                 zipf_skew=0, n_cores=256, n_addrs=bins, cycles=HIER_CYCLES)
            for pr, g in HIER_LINES for bins in SWEEP_BINS]


def phase_hier() -> dict:
    """The two-level queues and nb_feb on the card as one Study of ONE
    engine_run launch (48 points of one core count), every point bit for
    bit equal to its single run and without a poll (all are retry-free);
    updates per cycle and Jain fairness per line and bin, the launch's
    card time (CUDA events), the Study's wall against its single runs',
    the busy share."""
    specs = hier_specs()
    chk = sweep_check("hier", specs, 1)
    rows = {}
    for r in chk["results"]:
        pr, g = r.spec.protocol.name, r.spec.protocol.n_groups
        line = f"{pr}/g{g}" if pr in ("colibri_hier", "hw_event") else pr
        require(int(r.polls) == 0,
                f"hier {line}/{r.spec.topology.n_addrs}: {int(r.polls)} "
                f"polls")
        rows.setdefault(line, {})[r.spec.topology.n_addrs] = dict(
            updates_per_cycle=r.throughput, jain_fairness=r.jain_fairness)
    t = {(line, b): rows[line][b]["updates_per_cycle"]
         for line in rows for b in SWEEP_BINS}
    emit(phase="hier_rows", launches=chk["launches"], points=len(specs),
         cycles=HIER_CYCLES, equal=True, polls=0, rows=rows,
         hier_g4_over_colibri={b: t[("colibri_hier/g4", b)]
                               / t[("colibri", b)] for b in SWEEP_BINS})
    rec = study_time(specs, chk)
    emit(phase="hier_study_time", **rec)
    return rec


def phase_hier_time() -> dict:
    """engine_run's device time at HIER_TIME_POINTS (the three protocols
    at 256 × 1, FULL_WIDTH_CYCLES, beside colibri): µs per simulated
    cycle, the barrier floor and the byte bound; and the registers,
    spill and blocks per SM of every wide instance of the kernel, the
    one the three protocols run on (the sweep phase reports the
    others)."""
    runs = [time_run(full_width_spec(*pt), plain=False)
            for pt in HIER_TIME_POINTS]
    occ = [occupancy(n, 1, es_kernel.INSTANCE_WIDE)
           for n in (256, 1024, 2048, 2100)]
    rec = dict(points=[{k: r[k] for k in (
        "protocol", "n", "a", "cycles", "ms", "us_per_cycle",
        "barrier_floor_ms", "barriers_per_cycle", "bound_ms")}
        for r in runs], occupancy=occ)
    emit(phase="hier_time", **rec)
    return rec


def program_spec(proto: str, wl: str, n: int, cycles: int, **kw) -> Spec:
    """``wl`` at its scenario (``workloads.get(wl).scenario``)."""
    return Spec(protocol=proto, workload=wl, n_cores=n, cycles=cycles,
                **dict(workloads.get(wl).scenario, **kw))


def fig6_specs() -> list:
    """Fig. 6's points (``benchmarks/bench_queue.py``): FIG6_PROTOS ×
    FIG6_CORES, ms_queue at its scenario, FIG6_CYCLES, the fixed
    128-cycle backoff."""
    return [program_spec(pr, "ms_queue", n, FIG6_CYCLES, **FIG6_KW)
            for pr in FIG6_PROTOS for n in FIG6_CORES]


def phase_fig6() -> dict:
    """Fig. 6 on the card as one Study of ONE engine_run launch per core
    count (24 points, 6 launches), every point bit for bit equal to its
    single run and passing its workload's laws (``Result.check()``); the
    figure's rows (ops and atomics per cycle, Jain fairness, slowest and
    fastest core per protocol and core count), ``bench_queue.headline``'s
    entries computed from them, and the Study's card time per launch,
    wall and busy share (``study_time``)."""
    specs = fig6_specs()
    chk = sweep_check("fig6", specs, len(FIG6_CORES))
    rows = {}
    for r in chk["results"]:
        pr, n = r.spec.protocol.name, r.spec.topology.n_cores
        info = r.check()
        require(info["atomics"] > 0, f"fig6 {pr}/{n}: no atomic retired")
        rows.setdefault(pr, {})[n] = dict(
            ops_per_cycle=r.throughput,
            atomics_per_cycle=r.atomics_per_cycle,
            jain_fairness=r.jain_fairness, slowest_core=r.fairness_min,
            fastest_core=r.fairness_max, polls=r.polls)
    got = {f"{pr}/{n}": (row["ops_per_cycle"], row["jain_fairness"])
           for pr in rows for n, row in rows[pr].items()}
    bad = sorted(k for k in FIG6_REF if got.get(k) != FIG6_REF[k])
    require(not bad and set(got) == set(FIG6_REF),
            f"fig6 rows differ from the reference's at {bad}")
    t = {(pr, n): rows[pr][n] for pr in rows for n in rows[pr]}
    headline = {
        "colibri_over_lrsc_8cores": (t[("colibri", 8)]["ops_per_cycle"]
                                     / t[("lrsc", 8)]["ops_per_cycle"]),
        "colibri_over_lrsc_256cores": (
            t[("colibri", 256)]["ops_per_cycle"]
            / t[("lrsc", 256)]["ops_per_cycle"]),
        "colibri_jain_256": t[("colibri", 256)]["jain_fairness"],
        "lrsc_jain_256": t[("lrsc", 256)]["jain_fairness"],
        "hier_over_colibri_256": (t[("colibri_hier", 256)]["ops_per_cycle"]
                                  / t[("colibri", 256)]["ops_per_cycle"])}
    emit(phase="fig6_rows", launches=chk["launches"], points=len(specs),
         cycles=FIG6_CYCLES, equal=True, checked=True,
         equal_to_reference=True, rows=rows, headline=headline)
    rec = study_time(specs, chk)
    emit(phase="fig6_time", **rec)
    return dict(rec, headline=headline)


def grid_specs() -> list:
    """The workload grid's points (``benchmarks/bench_workloads.py``):
    GRID_WORKLOADS × GRID_PROTOS × GRID_SEEDS at GRID_CORES cores and
    GRID_CYCLES, each workload at its scenario, then its Zipf ladder
    (GRID_LADDER_PROTOS × GRID_ZIPF_LADDER)."""
    return [program_spec(pr, wl, GRID_CORES, GRID_CYCLES, seed=seed,
                         **GRID_OVERRIDES.get(wl, {}))
            for wl in GRID_WORKLOADS for pr in GRID_PROTOS
            for seed in GRID_SEEDS] + [
        program_spec(pr, "zipf_histogram", GRID_CORES, GRID_CYCLES,
                     zipf_skew=skew)
        for pr in GRID_LADDER_PROTOS for skew in GRID_ZIPF_LADDER]


def grid_labels() -> list:
    """The workload grid's row of each ``grid_specs`` point, the
    benchmark's labels: the workload for the grid, ``zipf_s<skew/100>``
    for the ladder."""
    n = len(GRID_WORKLOADS) * len(GRID_PROTOS) * len(GRID_SEEDS)
    return [s.workload.name if i < n
            else f"zipf_s{s.workload.zipf_skew / 100:.1f}"
            for i, s in enumerate(grid_specs())]


def phase_workloads() -> dict:
    """The workload grid on the card as one Study of ONE engine_run launch
    (56 points of 64 cores on the program instance: 50 of the grid, 6 of
    its Zipf ladder, skews 0, 1.0 and 2.0 in the sweep's form), every
    point bit for bit equal to its single run and passing
    ``Result.check()``, no poll for the polling-free protocols; ops per
    cycle per (workload, protocol), the mean over the seeds as the
    benchmark takes it, equal to the reference's (``GRID_REF``), colibri
    over lrsc per workload and ladder rung, and the Study's card time,
    wall and busy share (``study_time``)."""
    specs = grid_specs()
    chk = sweep_check("workloads", specs, 1)
    acc = {}
    for wl, r in zip(grid_labels(), chk["results"]):
        pr = r.spec.protocol.name
        r.check()
        require(pr not in POLLING_FREE or int(r.polls) == 0,
                f"workloads {wl}/{pr}: {int(r.polls)} polls")
        row = acc.setdefault(f"{wl}/{pr}", dict(ops_per_cycle=0.0,
                                                polls=0, n=0))
        row["ops_per_cycle"] += r.throughput
        row["polls"] += int(r.polls)
        row["n"] += 1
    for row in acc.values():                     # mean over the seeds
        row["ops_per_cycle"] /= row.pop("n")
    got = {k: (row["ops_per_cycle"], row["polls"]) for k, row in acc.items()}
    bad = sorted(k for k in GRID_REF if got.get(k) != GRID_REF[k])
    require(not bad and set(got) == set(GRID_REF),
            f"workload grid rows differ from the reference's at {bad}")
    ratio = {wl: acc[f"{wl}/colibri"]["ops_per_cycle"]
             / max(acc[f"{wl}/lrsc"]["ops_per_cycle"], 1e-9)
             for wl in GRID_WORKLOADS + tuple(
                 f"zipf_s{s / 100:.1f}" for s in GRID_ZIPF_LADDER)}
    emit(phase="workloads_rows", launches=chk["launches"],
         points=len(specs), cycles=GRID_CYCLES, equal=True, checked=True,
         equal_to_reference=True, rows=acc, colibri_over_lrsc=ratio)
    rec = study_time(specs, chk)
    emit(phase="workloads_time", **rec)
    return dict(rec, colibri_over_lrsc=ratio)


def phase_program_time() -> dict:
    """engine_run's device time for PROGRAM_TIME_PROTOS on each
    PROGRAM_WORKLOADS entry at 256 cores, FULL_WIDTH_CYCLES (its
    scenario's banks): µs per simulated cycle, the barrier floor and the
    byte bound; and the registers, spill and blocks per SM of every
    program instance of the kernel."""
    runs = [time_run(program_spec(pr, wl, 256, FULL_WIDTH_CYCLES),
                     plain=False)
            for wl in PROGRAM_WORKLOADS for pr in PROGRAM_TIME_PROTOS]
    occ = [occupancy(n, 1, es_kernel.INSTANCE_PROG)
           for n in (256, 1024, 2048, 2100)]
    rec = dict(points=[{k: r[k] for k in (
        "protocol", "workload", "n", "a", "cycles", "ms", "us_per_cycle",
        "barrier_floor_ms", "barriers_per_cycle", "bound_ms")}
        for r in runs], occupancy=occ)
    emit(phase="program_time", **rec)
    return rec


def fig3_skew_specs() -> list:
    """Fig. 3's skewed companion lines (``benchmarks/bench_histogram.py``):
    FIG3_SKEW_PROTOS × SWEEP_BINS at zipf_skew FIG3_SKEW, 256 cores,
    FIG3_SKEW_CYCLES."""
    return [Spec(protocol=pr, workload="zipf_histogram", zipf_skew=FIG3_SKEW,
                 n_cores=256, n_addrs=bins, cycles=FIG3_SKEW_CYCLES)
            for pr in FIG3_SKEW_PROTOS for bins in SWEEP_BINS]


def phase_fig3_skew() -> dict:
    """Fig. 3's 12 skewed points on the card as one Study of ONE
    engine_run launch, in the sweep's form of the stream (its threshold
    tables in the launch's buffer, a binary search per issue), every
    point bit for bit equal to its own single run (a Study of the point
    alone where the single run's form differs) and passing
    ``Result.check()``; the rows equal to the reference's
    (``FIG3_SKEW_REF``), the headline's colibri over lrsc at 1 024 bins,
    the Study's card time, wall and busy share."""
    specs = fig3_skew_specs()
    chk = sweep_check("fig3_skew", specs, 1)
    got = {}
    for r in chk["results"]:
        r.check()
        got[f"{r.spec.protocol.name}/{r.spec.topology.n_addrs}"] = (
            r.throughput, r.jain_fairness, int(r.polls), int(r.msgs),
            int(np.asarray(r.stats["ops"]).sum()))
    bad = sorted(k for k in FIG3_SKEW_REF if got.get(k) != FIG3_SKEW_REF[k])
    require(not bad and set(got) == set(FIG3_SKEW_REF),
            f"fig3 skewed rows differ from the reference's at {bad}")
    head = got["colibri/1024"][0] / got["lrsc/1024"][0]
    emit(phase="fig3_skew_rows", launches=chk["launches"], points=len(specs),
         cycles=FIG3_SKEW_CYCLES, skew=FIG3_SKEW, equal=True, checked=True,
         equal_to_reference=True, rows=got,
         sweep_form_differs=[f"{s.protocol.name}/{s.topology.n_addrs}"
                             for s in specs
                             if sweep_form_differs(s.to_params())],
         zipf15_colibri_over_lrsc_1024bins=head)
    rec = study_time(specs, chk)
    emit(phase="fig3_skew_time", **rec)
    return dict(rec, zipf15_colibri_over_lrsc_1024bins=head)


def topology_specs() -> tuple:
    """``benchmarks/bench_topology.py``'s points and row names: TOPO_MATRIX
    at each TOPO_CORES, then colibri_hier's TOPO_LADDER at 256 cores, all
    TOPO_ADDRS addresses, TOPO_CLUSTERS clusters, TOPO_CYCLES."""
    def spec(pr, topo, n):
        return Spec(protocol=pr, topology=topo, clusters=TOPO_CLUSTERS,
                    n_cores=n, n_addrs=TOPO_ADDRS, cycles=TOPO_CYCLES)
    pts = [(f"{pr}_{topo}_{n}c", spec(pr, topo, n))
           for n in TOPO_CORES for pr, topo in TOPO_MATRIX]
    pts += [(f"ladder_{topo}", spec("colibri_hier", topo, TOPO_CORES[0]))
            for topo in TOPO_LADDER]
    return [k for k, _ in pts], [s for _, s in pts]


def hops_per_op(r) -> float:
    """``bench_topology``'s hop traffic per completed op (0 on flat)."""
    ops = float(np.asarray(r.stats["ops"]).sum())
    return float(np.asarray(r.stats.get("hops", 0))) / max(ops, 1.0)


def phase_topology(dev) -> dict:
    """The topology grid on the card as one Study of one engine_run launch
    per core count (17 points, 2 launches on the topology instance, flat
    points beside hierarchical ones), every point bit for bit equal to its
    single run, ``hops`` only on the hierarchical points; the rows equal
    to the reference's (``TOPO_REF``), ``bench_topology.headline``'s
    entries from them; TOPO_PLAIN's points at TOPO_PLAIN_CYCLES against
    the plain loop on the card; the Study's card time, wall and busy
    share."""
    names, specs = topology_specs()
    chk = sweep_check("topology", specs, TOPO_LAUNCHES)
    got, by = {}, {}
    for name, r in zip(names, chk["results"]):
        require(("hops" in r.stats) == (r.spec.topology.name != "flat"),
                f"topology {name}: hops present on a flat run or absent "
                f"on a hierarchical one")
        got[name] = (r.throughput, r.jain_fairness, int(r.polls),
                     int(r.msgs), int(np.asarray(r.stats["ops"]).sum()),
                     hops_per_op(r))
        by[name] = r
    bad = sorted(k for k in TOPO_REF if got.get(k) != TOPO_REF[k])
    require(not bad and set(got) == set(TOPO_REF),
            f"topology rows differ from the reference's at {bad}")
    n = max(TOPO_CORES)

    def t(pr, topo):
        return got[f"{pr}_{topo}_{n}c"][0]
    hier = t("colibri_hier", "cluster2")
    headline = dict(
        hier_cluster2_over_flat_colibri=hier / t("colibri", "flat"),
        hier_over_lrsc_cluster2=hier / t("lrsc", "cluster2"),
        colibri_over_lrsc_cluster2=t("colibri", "cluster2")
        / t("lrsc", "cluster2"),
        hw_event_over_lrsc_cluster2=t("hw_event", "cluster2")
        / t("lrsc", "cluster2"),
        nb_feb_over_lrsc_cluster2=t("nb_feb", "cluster2")
        / t("lrsc", "cluster2"),
        lrsc_hops_per_op_cluster2=got[f"lrsc_cluster2_{n}c"][5],
        hier_hops_per_op_cluster2=got[f"colibri_hier_cluster2_{n}c"][5],
        lrsc_energy_over_hier_cluster2=(
            by[f"lrsc_cluster2_{n}c"].energy_pj_per_op
            / max(by[f"colibri_hier_cluster2_{n}c"].energy_pj_per_op,
                  1e-12)),
        ladder_monotone=float(all(
            got[f"ladder_{a}"][0] >= got[f"ladder_{b}"][0] * 0.99
            for a, b in zip(TOPO_LADDER, TOPO_LADDER[1:]))))
    plain_launches, worst = 0, 0.0
    for pr, topo, cores in TOPO_PLAIN:
        p = sim.SimParams(protocol=pr, topology=topo, clusters=TOPO_CLUSTERS,
                          n_cores=cores, n_addrs=TOPO_ADDRS,
                          cycles=TOPO_PLAIN_CYCLES)
        launches, err, _ = run_case(p, dev)
        plain_launches += launches
        worst = max(worst, err)
    reset_launches()                   # comparison runs: no path's count
    emit(phase="topology_rows", launches=chk["launches"], points=len(specs),
         cycles=TOPO_CYCLES, equal=True, equal_to_reference=True, rows=got,
         headline=headline, plain_points=TOPO_PLAIN,
         plain_cycles=TOPO_PLAIN_CYCLES, plain_launches=plain_launches,
         max_abs_err=worst)
    rec = study_time(specs, chk)
    emit(phase="topology_time", **rec)
    return dict(rec, headline=headline, max_abs_err=worst)


@contextlib.contextmanager
def instance(variant: int):
    """Every engine_run launch of the block on the kernel's instance
    ``variant`` (``es_kernel.INSTANCE_*``), whatever its runs."""
    pick = es_kernel.launch_variant
    es_kernel.launch_variant = lambda scalars: variant
    try:
        yield
    finally:
        es_kernel.launch_variant = pick


def phase_topo_time() -> dict:
    """engine_run's device time (µs per simulated cycle, FULL_WIDTH_CYCLES)
    of colibri at 256 cores and TOPO_ADDRS addresses on flat (its own
    instance, then the topology instance), cluster2 and cluster3, and of
    the Zipf lookup: colibri and lrsc at 256 × 1 024 bins, skew 0 (the
    fused multiply-add) beside ZIPF_TIME_SKEW (the threshold search);
    the topology instance's registers, spill and blocks per SM."""
    def spec(**kw):
        return Spec(protocol="colibri", n_cores=256, n_addrs=TOPO_ADDRS,
                    clusters=TOPO_CLUSTERS, cycles=FULL_WIDTH_CYCLES,
                    **kw)
    keys = ("protocol", "n", "a", "cycles", "ms", "us_per_cycle",
            "barrier_floor_ms", "barriers_per_cycle", "bound_ms")
    topo = {"flat": time_run(spec(), plain=False)}
    with instance(es_kernel.INSTANCE_TOPO):
        topo["flat_on_topology_instance"] = time_run(spec(), plain=False)
    for name in ("cluster2", "cluster3"):
        topo[name] = time_run(spec(topology=name), plain=False)
    zipf = {}
    for pr in ("colibri", "lrsc"):
        for skew in (0, ZIPF_TIME_SKEW):
            zipf[f"{pr}/{skew}"] = time_run(Spec(
                protocol=pr, workload="zipf_histogram", zipf_skew=skew,
                n_cores=256, n_addrs=1024, cycles=FULL_WIDTH_CYCLES),
                plain=False)
    occ = [occupancy(n, a, es_kernel.INSTANCE_TOPO)
           for n, a in ((256, TOPO_ADDRS), (1024, TOPO_ADDRS), (2048, 64),
                        (2100, 64))]
    rec = dict(topology={k: {x: r[x] for x in keys} for k, r in topo.items()},
               zipf={k: {x: r[x] for x in keys} for k, r in zipf.items()},
               occupancy=occ)
    emit(phase="topo_time", **rec)
    return rec


def fault_specs() -> tuple:
    """``benchmarks/bench_faults.py``'s points in its order, with names:
    per FAULTS_PROTOS entry its healthy run (``healthy_*``, the rows'
    divisor) and the owner kill with and without the watchdog; the drop
    curve (watchdog on); the watchdog ablation on lrscwait."""
    def spec(pr, **fp):
        return Spec(protocol=pr, n_cores=FAULTS_CORES, n_addrs=FAULTS_ADDRS,
                    cycles=FAULTS_CYCLES,
                    faults=FaultPlan(**fp) if fp else None)
    pts = []
    for pr in FAULTS_PROTOS:
        pts += [(f"healthy_{pr}", spec(pr)),
                (f"kill_wd_{pr}", spec(pr, **FAULTS_KILL)),
                (f"kill_nowd_{pr}", spec(pr, **dict(FAULTS_KILL,
                                                    watchdog_cyc=0)))]
    for pr in FAULTS_DROP_PROTOS:
        pts += [(f"drop_{bp}bp_{pr}", spec(
            pr, msg_drop_bp=bp, watchdog_cyc=FAULTS_KILL["watchdog_cyc"],
            progress_cyc=FAULTS_KILL["progress_cyc"])) for bp in FAULTS_DROPS]
    pts += [(f"wd_{wd}_lrscwait", spec("lrscwait", **dict(
        FAULTS_KILL, watchdog_cyc=wd))) for wd in FAULTS_WD]
    return [k for k, _ in pts], [s for _, s in pts]


def fault_rows(by: dict) -> tuple:
    """``bench_faults.rows()`` and ``headline()`` from the results by
    ``fault_specs`` name."""
    rows, wd = [], FAULTS_KILL["watchdog_cyc"]
    for pr in FAULTS_PROTOS:
        healthy = by[f"healthy_{pr}"].throughput
        for tag in ("wd", "nowd"):
            r = by[f"kill_{tag}_{pr}"]
            rows.append(r.to_row(
                figure="faults", row=f"kill_{tag}_{pr}",
                watchdog_cyc=r.spec.faults.watchdog_cyc,
                n_kill=FAULTS_KILL["n_kill"], healthy_throughput=healthy,
                throughput_retention=(r.stats["survivor_throughput"]
                                      / healthy if healthy else 0.0)))
    for pr in FAULTS_DROP_PROTOS:
        base = by[f"drop_0bp_{pr}"].throughput
        for bp in FAULTS_DROPS:
            r = by[f"drop_{bp}bp_{pr}"]
            rows.append(r.to_row(
                figure="faults", row=f"drop_{bp}bp_{pr}", msg_drop_bp=bp,
                watchdog_cyc=wd, throughput_retention=(
                    r.throughput / base if base else 0.0)))
    for w in FAULTS_WD:
        rows.append(by[f"wd_{w}_lrscwait"].to_row(
            figure="faults", row=f"wd_{w}_lrscwait", watchdog_cyc=w,
            n_kill=FAULTS_KILL["n_kill"]))
    row = {r["row"]: r for r in rows}
    held = [p for p in FAULTS_PROTOS if p != "amo"]
    head = dict(
        protocols_live_with_watchdog=float(sum(
            bool(row[f"kill_wd_{p}"]["progress_ok"]) for p in FAULTS_PROTOS)),
        protocols_total=float(len(FAULTS_PROTOS)),
        deadlocks_detected_without_watchdog=float(sum(
            not row[f"kill_nowd_{p}"]["progress_ok"] for p in held)),
        deadlockable_protocols=float(len(held)))
    for p in ("lrscwait", "colibri_hier"):
        head[f"kill_wd_retention_{p}"] = \
            row[f"kill_wd_{p}"]["throughput_retention"]
    top = max(FAULTS_DROPS)
    for p in FAULTS_DROP_PROTOS:
        head[f"drop{top}bp_retention_{p}"] = \
            row[f"drop_{top}bp_{p}"]["throughput_retention"]
    return rows, head


def phase_faults() -> dict:
    """``bench_faults.py`` on the card as one Study of ONE engine_run
    launch on the fault instance (38 fault points and the 9 healthy
    runs, 64 cores), every point bit for bit equal to its single run;
    the rows and the headline equal to the committed report's
    (FAULTS_REPORT), key for key, each row with FAULTS_ROW_ADDED; the
    launch's card time, the Study's wall against its single runs', the
    busy share."""
    names, specs = fault_specs()
    chk = sweep_check("faults", specs, 1)
    rows, head = fault_rows(dict(zip(names, chk["results"])))
    ref = json.loads(FAULTS_REPORT.read_text())["faults"]
    rows = json.loads(json.dumps(rows))
    bad = [r["row"] for r, w in zip(rows, ref["rows"])
           if r != dict(w, **FAULTS_ROW_ADDED)]
    require(len(rows) == len(ref["rows"]) == 38 and not bad,
            f"faults rows differ from {FAULTS_REPORT.name} at {bad}")
    require(head == ref["headline"],
            f"faults headline {head} != {ref['headline']}")
    require(head["protocols_live_with_watchdog"] == head["protocols_total"]
            and head["deadlocks_detected_without_watchdog"]
            == head["deadlockable_protocols"],
            f"faults headline {head}")
    emit(phase="faults_rows", launches=chk["launches"], points=len(specs),
         rows=len(rows), cycles=FAULTS_CYCLES, equal=True,
         equal_to_reference=True, headline=head)
    rec = study_time(specs, chk)
    emit(phase="faults_time", **rec)
    return dict(rec, headline=head)


def phase_fault_time() -> dict:
    """engine_run's device time (µs per simulated cycle) of
    FAULT_TIME_PROTOS at 256 × 1 over FULL_WIDTH_CYCLES under the
    benchmark's owner kill (FAULTS_KILL, the fault instance) beside the
    empty plan on their own instance, on the topology instance (the
    fault instance's code without the fault stages) and on the fault
    instance; the fault instance's registers, spill and blocks per SM at
    256 and 1 024 threads."""
    keys = ("protocol", "n", "a", "cycles", "ms", "us_per_cycle",
            "barrier_floor_ms", "barriers_per_cycle", "bound_ms")
    pts = {}
    for pr in FAULT_TIME_PROTOS:
        def spec(**kw):
            return Spec(protocol=pr, n_cores=256, n_addrs=1,
                        cycles=FULL_WIDTH_CYCLES, **kw)
        pts[f"{pr}/kill"] = time_run(spec(faults=FaultPlan(**FAULTS_KILL)),
                                     plain=False)
        pts[f"{pr}/none"] = time_run(spec(), plain=False)
        for name, variant in (("topology", es_kernel.INSTANCE_TOPO),
                              ("fault", es_kernel.INSTANCE_FAULT)):
            with instance(variant):
                pts[f"{pr}/none_on_{name}_instance"] = time_run(
                    spec(), plain=False)
    occ = [occupancy(n, 1, es_kernel.INSTANCE_FAULT) for n in (256, 1024)]
    rec = dict(points={k: {x: r[x] for x in keys} for k, r in pts.items()},
               occupancy=occ)
    emit(phase="fault_time", **rec)
    return rec


def launch_floor_ms(dev) -> float:
    """Device time of the least launch: one elementwise add on a
    one-element tensor (``add_(1)``), as ``device_ms`` reads it."""
    one = torch.ones(1, device=dev)
    return device_ms(lambda: one.add_(1), 100)


def scatter_bound(t: int, bins: int, d: int, size: int) -> dict:
    """The commit's byte bound: keys (4T) and values read once, the
    output written once."""
    n_bytes = 4 * t + (t + bins) * d * size
    return dict(bound_bytes=n_bytes, bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3)


def time_scatter(dev, t: int, bins: int, d: int, dtype: str,
                 keys=None) -> dict:
    """Device time per call of the commit kernel (on pre-sorted
    inputs), the whole op (sort + commit), the plain version and
    ``index_add_`` (and, for histograms, ``colibri_histogram`` and
    ``torch.bincount``), beside the commit's bound; on seeded uniform
    keys, or on ``keys`` (int32, on the card) with standard-normal
    values."""
    if keys is None:
        keys, vals = scatter_inputs(dev, t, bins, d, dtype,
                                    seed=t + bins + d)
    else:
        g = torch.Generator(device=dev).manual_seed(t + bins + d)
        vals = torch.randn((t, d), generator=g, device=dev).to(
            getattr(torch, dtype))
    order = torch.argsort(keys, stable=True)
    sk, sv = keys[order].contiguous(), vals[order].contiguous()
    buf = torch.zeros((bins, d), dtype=vals.dtype, device=dev)
    reps = 20 if t * d >= 1 << 20 else 100
    launches = LAUNCHES["colibri_scatter"]
    rec = dict(
        t=t, bins=bins, d=d, dtype=dtype,
        ms=device_ms(lambda: cs_kernel.scatter_commit_cuda(sk, sv, bins),
                     reps),
        op_ms=device_ms(lambda: colibri_scatter.colibri_scatter_add(
            keys, vals, bins), reps),
        plain_ms=device_ms(lambda: colibri_scatter.scatter_add_ref(
            keys, vals, bins), reps),
        library_ms=device_ms(lambda: buf.index_add_(0, keys, vals), reps),
        **scatter_bound(t, bins, d, vals.element_size()))
    if d == 1 and dtype == "float32":
        lk = keys.long()
        rec["histogram_op_ms"] = device_ms(
            lambda: colibri_scatter.colibri_histogram(keys, bins), reps)
        rec["bincount_ms"] = device_ms(
            lambda: torch.bincount(lk, minlength=bins), reps)
    LAUNCHES["colibri_scatter"] = launches     # timing runs are not counted
    return rec


def time_trace_streams(dev, streams: dict) -> list:
    """The commit kernel on the trace path's own sorted streams (the
    bins repeated by their counts, ones as values: what
    ``trace_latency_hist`` hands it), beside uniform keys of the same
    length; the skew costs nothing if the two times agree."""
    launches = LAUNCHES["colibri_scatter"]
    rows = []
    for key, hist in streams.items():
        bins = len(hist)
        sk = torch.from_numpy(np.repeat(np.arange(bins, dtype=np.int32),
                                        hist)).to(dev)
        t = sk.numel()
        ones = torch.ones((t, 1), device=dev)
        uk = torch.sort(torch.randint(0, bins, (t,), device=dev,
                                      dtype=torch.int32)).values
        rows.append(dict(
            point=key, t=t, bins=bins,
            top_bin_share=max(hist) / t,
            ms=device_ms(lambda: cs_kernel.scatter_commit_cuda(sk, ones,
                                                               bins), 100),
            uniform_ms=device_ms(lambda: cs_kernel.scatter_commit_cuda(
                uk, ones, bins), 100),
            **scatter_bound(t, bins, 1, 4)))
    LAUNCHES["colibri_scatter"] = launches     # timing runs are not counted
    return rows


# ---- the LM serve path ---------------------------------------------------

def flash_inputs(dev, b, sq, skv, h, kv, hd, dtype, seed, hdv=None):
    """Seeded standard-normal q ``(b, sq, h, hd)``, k ``(b, skv, kv,
    hd)`` and v ``(b, skv, kv, hdv)`` (hdv = hd by default) on the
    card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dt)
                 for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                               (b, skv, kv, hdv or hd)))


def phase_flash_kernel(dev) -> dict:
    worst = dict.fromkeys(FLASH_TOL, 0.0)
    for i, (b, sq, skv, h, kv, hd, causal, dtype) in enumerate(FLASH_SHAPES):
        q, k, v = flash_inputs(dev, b, sq, skv, h, kv, hd, dtype, i)
        out = flash_attention.flash_attention(q, k, v, causal=causal)
        ref = flash_attention.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        what = f"{(b, sq, skv, h, kv, hd)} causal={causal} {dtype}"
        require(out.dtype == q.dtype and out.shape == q.shape,
                f"{what}: output {out.dtype}{tuple(out.shape)}")
        rtol, atol = FLASH_TOL[dtype]
        err = float((out.float() - ref.float()).abs().max())
        require(torch.allclose(out.float(), ref.float(), rtol=rtol,
                               atol=atol),
                f"{what}: kernel differs from plain by {err}")
        if b > 1:       # one request alone: the same bits as in the batch
            solo = flash_attention.flash_attention(
                q[-1:].contiguous(), k[-1:].contiguous(), v[-1:].contiguous(),
                causal=causal)
            require(torch.equal(solo, out[-1:]),
                    f"{what}: the last request alone differs from its rows "
                    f"in the batch")
        worst[dtype] = max(worst[dtype], err)
    emit(phase="flash_kernel", cases=len(FLASH_SHAPES), shapes=FLASH_SHAPES,
         max_abs_err=worst, tolerance=FLASH_TOL, equal=True,
         batch_invariant=True)
    return worst


def rglru_inputs(dev, t, b, w, seed):
    """Seeded decays in (0, 1), inputs and initial state on the card, as
    the reference tests draw them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.sigmoid(torch.randn((t, b, w), generator=g, device=dev) + 2.0)
    x = torch.randn((t, b, w), generator=g, device=dev) * 0.3
    return a, x, torch.randn((b, w), generator=g, device=dev)


def batch_major(x: torch.Tensor) -> torch.Tensor:
    """The same (T, B, w) values as the model hands them to the scan: a
    (T, B, w) view of a contiguous (B, T, w) tensor."""
    return x.transpose(0, 1).contiguous().transpose(0, 1)


def phase_rglru_kernel(dev) -> float:
    """The kernel against the plain version at every shape, on contiguous
    inputs and on the model's strided views (where h must come back with
    a's strides)."""
    worst = 0.0
    rtol, atol = RGLRU_TOL
    for i, (t, b, w) in enumerate(RGLRU_SHAPES):
        a, x, h0 = rglru_inputs(dev, t, b, w, i)
        ref = rglru_scan.rglru_scan_ref(a, x, h0)
        for layout, (aa, xx) in (("contiguous", (a, x)),
                                 ("batch_major", (batch_major(a),
                                                  batch_major(x)))):
            out = rglru_scan.rglru_scan(aa, xx, h0)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            require(out.dtype == torch.float32
                    and tuple(out.shape) == (t, b, w)
                    and out.stride() == aa.stride()
                    and torch.allclose(out, ref, rtol=rtol, atol=atol),
                    f"{(t, b, w)} {layout}: kernel differs from plain by "
                    f"{err} (strides {out.stride()}, a's {aa.stride()})")
            worst = max(worst, err)
    emit(phase="rglru_kernel", cases=2 * len(RGLRU_SHAPES),
         shapes=RGLRU_SHAPES, layouts=["contiguous", "batch_major"],
         max_abs_err=worst, tolerance=RGLRU_TOL, equal=True)
    return worst


def rwkv_inputs(dev, b, t, h, hd, decay, seed):
    """Seeded r, k, v, w ``(b, t, h, hd)`` and u ``(h, hd)`` on the card,
    as the reference tests draw them: r, k ~ N(0, 0.25), v ~ N(0, 1),
    w = exp(-exp(x)) with x ~ N(decay, 1), u ~ N(0, 0.01)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    r, k, v = randn(b, t, h, hd) * 0.5, randn(b, t, h, hd) * 0.5, \
        randn(b, t, h, hd)
    w = torch.exp(-torch.exp(randn(b, t, h, hd) + decay))
    return r, k, v, w, randn(h, hd) * 0.1


def phase_rwkv_kernel(dev) -> float:
    """The kernel's output and final state against the plain version's,
    for every shape and decay distribution."""
    worst, cases = 0.0, []
    rtol, atol = RWKV_TOL
    for i, shape in enumerate(RWKV_SHAPES):
        for decay in RWKV_DECAYS:
            ins = rwkv_inputs(dev, *shape, decay, seed=i)
            out, state = rwkv6_wkv.wkv(*ins)
            ref_out, ref_state = rwkv6_wkv.wkv_ref(*ins)
            torch.cuda.synchronize()
            b, t, h, hd = shape
            what = f"{shape} decay N({decay}, 1)"
            require(tuple(out.shape) == shape
                    and tuple(state.shape) == (b, h, hd, hd),
                    f"{what}: out {tuple(out.shape)}, state "
                    f"{tuple(state.shape)}")
            err_o = float((out - ref_out).abs().max())
            err_s = float((state - ref_state).abs().max())
            require(torch.allclose(out, ref_out, rtol=rtol, atol=atol)
                    and torch.allclose(state, ref_state, rtol=rtol,
                                       atol=atol),
                    f"{what}: kernel differs from plain by {err_o} (out), "
                    f"{err_s} (state)")
            cases.append(dict(shape=shape, decay=decay, out_err=err_o,
                              state_err=err_s,
                              out_max=float(ref_out.abs().max())))
            worst = max(worst, err_o, err_s)
    emit(phase="rwkv_kernel", cases=cases, max_abs_err=worst,
         tolerance=RWKV_TOL, equal=True)
    return worst


def prompts(vocab: int, n: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.int32)


def serve(eng, toks: np.ndarray, new: int) -> np.ndarray:
    """One batch of ``toks`` through ``eng``; the greedy tokens."""
    reqs = [Request(prompt=p, max_new_tokens=new, id=i)
            for i, p in enumerate(toks)]
    for r in reqs:
        eng.submit(r)
    require(eng.run_once() == len(reqs), "the engine left requests")
    return np.stack([r.result for r in reqs])


def greedy_logits(model, toks: np.ndarray, new: int, cache_len: int,
                  forced=None, feats=None):
    """The engine's steps for equal-length prompts, keeping the logits:
    prefill (given the frontend's ``feats``, a dict of CPU tensors, if
    any), then ``new`` decode steps, each fed the argmax of the last
    logits, or ``forced[:, step]``.  Returns (logits of each step on the
    CPU, (B, new) tokens fed)."""
    dev = model.device
    hidden, cache = model.prefill(
        torch.from_numpy(toks).to(dev), cache_len,
        **{k: v.to(dev) for k, v in (feats or {}).items()})
    out = [model.logits(hidden[:, -1:])[:, -1]]
    fed = []
    for step in range(new):
        tok = (out[-1].argmax(-1).int() if forced is None
               else torch.from_numpy(forced[:, step]).to(dev))
        fed.append(tok.cpu().numpy())
        pos = torch.full((toks.shape[0],), toks.shape[1] + step,
                         dtype=torch.int32, device=dev)
        lg, cache = model.decode_step(cache, tok[:, None], pos)
        out.append(lg[:, -1])
    return [o.float().cpu() for o in out], np.stack(fed, axis=1)


def lm_launches_ok(launches: dict, want: dict) -> bool:
    """Each LM kernel launched exactly as often as ``want`` says (0 where
    it names none)."""
    return all(launches[k] == want.get(k, 0) for k in LM_KERNELS)


class RouterLog:
    """While open, records each call of the MoE router (``moe._route``):
    its picks ``ids`` (T, k) and the k + 1 largest router probabilities
    ``top`` (T, k + 1), on the CPU."""

    def __init__(self):
        self.calls = []
        self._route = moe._route

    def __enter__(self):
        def route(cfg, router_w, x_flat):
            out = self._route(cfg, router_w, x_flat)
            probs = torch.softmax(x_flat.float() @ router_w.float(), dim=-1)
            self.calls.append(dict(
                ids=out[0].cpu(),
                top=torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values.cpu()))
            return out
        moe._route = route
        return self

    def __exit__(self, *exc):
        moe._route = self._route


def router_diffs(cpu: RouterLog, card: RouterLog, k: int) -> list:
    """The tokens whose k picks (as a set) differ between the CPU's and
    the card's router, call by call, with the gap between the k-th and
    (k+1)-th router probabilities on each side."""
    require(len(cpu.calls) == len(card.calls),
            f"{len(cpu.calls)} router calls on the CPU, {len(card.calls)} "
            f"on the card")
    diffs = []
    for i, (a, b) in enumerate(zip(cpu.calls, card.calls)):
        rows = (a["ids"].sort(-1).values != b["ids"].sort(-1).values).any(-1)
        for r in rows.nonzero().flatten().tolist():
            diffs.append(dict(call=i, token=r,
                              cpu_gap=float(a["top"][r, k - 1]
                                            - a["top"][r, k]),
                              card_gap=float(b["top"][r, k - 1]
                                             - b["top"][r, k])))
    return diffs


#: the keys of a serve point that cut its config (``lm_cfg``)
CUT_KEYS = ("layers", "enc_layers", "experts", "moe_start")


def lm_cfg(arch: str, cut: dict, **kw):
    """``arch``'s config cut as ``cut`` says (``layers``: depth;
    ``enc_layers``: the encoder's depth; ``experts``: the MoE layers'
    routed experts; ``moe_start``: the first MoE layer), with ``kw``
    replaced."""
    cfg = get_config(arch)
    if "layers" in cut:
        kw["num_layers"] = cut["layers"]
    if "enc_layers" in cut:
        kw["encoder"] = dataclasses.replace(cfg.encoder,
                                            num_layers=cut["enc_layers"])
    moe_kw = {k: cut[c] for k, c in (("num_experts", "experts"),
                                     ("moe_layer_start", "moe_start"))
              if c in cut}
    if moe_kw:
        kw["moe"] = dataclasses.replace(cfg.moe, **moe_kw)
    return dataclasses.replace(cfg, **kw)


def serve_a(dev, arch: str, sa: dict, want: dict, phase: str,
            want_decode: dict = None, tokens_equal: bool = False,
            frontend=None) -> dict:
    """Full width, ``sa["layers"]`` layers, f32: the card's prefill and
    decode logits against the port's on the CPU, on the same weights,
    teacher-forced on the CPU's greedy tokens.  The card's prefill must
    launch the LM kernels as ``want`` says, each decode step as
    ``want_decode`` says (none by default).  Router picks that differ
    between the two are reported, and each must be a near-tie.  With
    ``frontend`` (cfg, sa -> {name: numpy array}), the logits are taken
    on those seeded inputs of the frontend stub (frame or patch
    embeddings), the engines' tokens on the engine's zero ones; with
    ``tokens_equal``, the card's greedy picks on the seeded inputs must
    equal the CPU's too."""
    gc.collect()                       # earlier phases' models
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want_decode = want_decode or {}
    cfg = lm_cfg(arch, sa, param_dtype="float32", compute_dtype="float32")
    cache_len = sa["prompt"] + sa["new"]
    toks = prompts(cfg.vocab_size, sa["requests"], sa["prompt"], sa["seed"])
    feats = {k: torch.from_numpy(v)
             for k, v in (frontend(cfg, sa) if frontend else {}).items()}
    card = build(cfg, dev).init(sa["seed"])
    cpu = build(cfg, "cpu").load_params(card.params())
    t0 = time.perf_counter()
    cpu_tokens = serve(ServeEngine(cfg, cpu, batch_size=sa["requests"],
                                   cache_len=cache_len, device="cpu"),
                       toks, sa["new"])
    with RouterLog() as cpu_routes:
        cpu_logits, fed = greedy_logits(cpu, toks, sa["new"], cache_len,
                                        feats=feats)
    cpu_s = time.perf_counter() - t0
    require(bool(feats) or np.array_equal(fed, cpu_tokens),
            f"CPU engine tokens {cpu_tokens} != its greedy steps {fed}")
    del cpu
    probe = Probe(card)
    reset_launches()
    with RouterLog() as card_routes:
        card_logits, _ = greedy_logits(card, toks, sa["new"], cache_len,
                                       forced=fed, feats=feats)
    launches = dict(LAUNCHES)
    card_greedy = np.stack([lg.argmax(-1).int().numpy()
                            for lg in card_logits[:-1]], axis=1)
    pre, dec = probe.calls["prefill"][:], probe.calls["decode_step"][:]
    card_tokens = serve(ServeEngine(cfg, card, batch_size=sa["requests"],
                                    cache_len=cache_len), toks, sa["new"])
    diffs = (router_diffs(cpu_routes, card_routes, cfg.moe.top_k)
             if cfg.moe is not None else [])
    rtol, atol = SERVE_A_TOL
    errs = []
    for step, (c, g) in enumerate(zip(cpu_logits, card_logits)):
        require(bool(torch.isfinite(g).all()), f"step {step}: logits not "
                                                f"finite")
        errs.append(float((g - c).abs().max()))
        require(torch.allclose(g, c, rtol=rtol, atol=atol),
                f"step {step}: card logits differ from the CPU's by "
                f"{errs[-1]} (router picks that differ: {diffs})")
    require(all(d["cpu_gap"] <= NEAR_TIE for d in diffs),
            f"router picks differ beyond a near-tie: {diffs}")
    require(len(pre) == 1 and lm_launches_ok(pre[0]["launches"], want)
            and len(dec) == sa["new"]
            and all(lm_launches_ok(c["launches"], want_decode) for c in dec),
            f"the prefill launched {[c['launches'] for c in pre]} and the "
            f"decode steps {[c['launches'] for c in dec]}, want {want} and "
            f"{want_decode} per step")
    require(not tokens_equal or np.array_equal(cpu_tokens, card_tokens),
            f"card tokens {card_tokens} != CPU tokens {cpu_tokens}")
    require(not (tokens_equal and feats) or np.array_equal(card_greedy, fed),
            f"card greedy picks {card_greedy} != the CPU's {fed} on the "
            f"seeded {sorted(feats)}")
    emit(phase=phase, arch=arch, layers=sa["layers"],
         enc_layers=sa.get("enc_layers"), frontend_inputs=sorted(feats),
         experts=cfg.moe.num_experts if cfg.moe is not None else None,
         reduced=dict({k: sa[k] for k in CUT_KEYS if k in sa},
                      dtype="float32"),
         requests=sa["requests"], prompt=sa["prompt"], new=sa["new"],
         dtype="float32", max_abs_err_by_step=errs, max_abs_err=max(errs),
         tolerance=SERVE_A_TOL, launches=launches,
         prefill_launches=pre[0]["launches"],
         router_calls=len(card_routes.calls), router_diffs=diffs,
         cpu_tokens=cpu_tokens.tolist(), card_tokens=card_tokens.tolist(),
         tokens_agree=bool(np.array_equal(cpu_tokens, card_tokens)),
         cpu_greedy=fed.tolist(),
         card_greedy_agrees=bool(np.array_equal(card_greedy, fed)),
         cpu_seconds=cpu_s, equal=True)
    return dict(max_abs_err=max(errs))


def phase_serve_a(dev) -> dict:
    """recurrentgemma-2b, one (rglru, rglru, local) unit."""
    return serve_a(dev, SERVE_ARCH, SERVE_A, SERVE_A_LAUNCHES, "serve_a")


def phase_rwkv_serve_a(dev) -> dict:
    """rwkv6-1.6b, two (rwkv, rwkv_cm) layers."""
    return serve_a(dev, RWKV_ARCH, RWKV_SERVE_A, RWKV_SERVE_A_LAUNCHES,
                   "rwkv_serve_a")


class Probe:
    """Wraps a model's ``prefill``, ``decode_step`` and ``logits``: per
    call, the kernel launches it made, its wall seconds (ended by a
    synchronize) and whether its floats were finite."""

    def __init__(self, model):
        self.calls = {"prefill": [], "decode_step": [], "logits": []}
        for name in self.calls:
            setattr(model, name, self._wrap(name, getattr(model, name)))

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            first = out[0] if isinstance(out, tuple) else out
            self.calls[name].append(dict(
                seconds=time.perf_counter() - t0,
                finite=bool(torch.isfinite(first).all()),
                launches={k: LAUNCHES[k] - before[k] for k in LAUNCHES}))
            return out
        return call


def profile_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall ms (ended by
    a synchronize), the device time of what it launched, the busy share
    and the top device activities by time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[2] for r in rows)
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
                device_busy_share=busy / 1e6 / wall,
                device_activities=sum(r[1] for r in rows),
                top=[dict(kernel=k[:70], count=c, us=t)
                     for k, c, t in rows[:8]])


def serve_b(dev, arch: str, sb: dict, want: dict, phase: str,
            want_decode: dict = None) -> dict:
    """A main path of the LM: ``arch`` at full width (bf16, seeded on the
    card; at full depth unless ``sb["layers"]`` cuts it) serving one batch
    through ServeEngine.  Each prefill must launch the LM kernels as
    ``want`` says, each decode step as ``want_decode`` says (none by
    default)."""
    gc.collect()                       # earlier phases' models
    torch.cuda.empty_cache()
    want_decode = want_decode or {}
    cfg = lm_cfg(arch, sb)
    cache_len = sb["prompt"] + sb["new"]
    toks = prompts(cfg.vocab_size, sb["requests"], sb["prompt"], sb["seed"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, dev).init(sb["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    eng = ServeEngine(cfg, model, batch_size=sb["requests"],
                      cache_len=cache_len)
    serve(eng, toks, sb["new"])                          # warm
    probe = Probe(model)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tokens = serve(eng, toks, sb["new"])
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    solo = serve(eng, toks[:1], sb["new"])
    # where the time goes: one prefill and one decode step, profiled
    # (not part of the counted run)
    launches_after = dict(LAUNCHES)
    x = torch.from_numpy(toks).to(dev)
    state = {}

    def prefill(t):
        """The engine's prefill of the prompts ``t``, frontend inputs
        and all."""
        return model.prefill(t, cache_len, **frontend_inputs(
            cfg, t.shape[0], t.shape[1], dev))

    def pre_call():
        state["out"] = prefill(x)

    def dec_call():
        hidden, cache = state["out"]
        tok = model.logits(hidden[:, -1:])[:, -1].argmax(-1).int()[:, None]
        pos = torch.full((sb["requests"],), sb["prompt"], dtype=torch.int32,
                         device=dev)
        model.decode_step(cache, tok, pos)
    profiles = dict(prefill=profile_call(pre_call),
                    decode_step=profile_call(dec_call))
    # request 0's last-position prefill logits alone against in the batch:
    # the batch dependence of the whole model (the kernels' own is nil:
    # flash_kernel, gmm_kernel), which decides solo_agrees at a near-tie
    solo_logits, batch_logits = (
        model.logits(prefill(t)[0][:1, -1:]).float() for t in (x[:1], x))
    solo_diff = float((solo_logits - batch_logits).abs().max())
    LAUNCHES.update(launches_after)
    pre, dec = probe.calls["prefill"][0], probe.calls["decode_step"][:sb["new"]]
    require(all(c["finite"] for c in probe.calls["prefill"]
                + probe.calls["decode_step"] + probe.calls["logits"]),
            "non-finite hidden states or logits")
    require(tokens.shape == (sb["requests"], sb["new"]),
            f"tokens {tokens.shape}")
    batch_want = {k: want.get(k, 0) + sb["new"] * want_decode.get(k, 0)
                  for k in LM_KERNELS}
    require(lm_launches_ok(pre["launches"], want)
            and lm_launches_ok(launches, batch_want),
            f"{pre['launches']} launches in the prefill, {launches} in the "
            f"batch, want {want} and {batch_want}")
    require(all(c["launches"][k] == want_decode.get(k, 0)
                for c in dec for k in LAUNCHES),
            f"decode launched {[c['launches'] for c in dec]}, want "
            f"{want_decode} per step")
    decode_s = sum(c["seconds"] for c in dec)
    emit(phase=phase, arch=arch, layers=cfg.num_layers,
         enc_layers=cfg.encoder.num_layers if cfg.encoder else None,
         reduced={k: sb[k] for k in CUT_KEYS if k in sb},
         params=n_params, weight_bytes=weight_bytes, dtype=cfg.param_dtype,
         requests=sb["requests"],
         prompt=sb["prompt"], new=sb["new"], init_s=init_s,
         init_peak_memory_bytes=init_peak,
         launches=launches, prefill_launches=pre["launches"],
         decode_launches=sum(sum(c["launches"].values()) for c in dec),
         prefill_ms=pre["seconds"] * 1e3,
         decode_ms_per_token=decode_s / len(dec) * 1e3,
         batch_wall_s=wall,
         tokens_per_s=sb["requests"] * sb["new"] / wall,
         peak_memory_bytes=peak, tokens=tokens.tolist(),
         solo_tokens=solo[0].tolist(),
         solo_agrees=bool(np.array_equal(solo[0], tokens[0])),
         solo_prefill_logits_diff=solo_diff,
         logits_finite=True, profile=profiles)
    return dict(launches=launches)


def phase_serve_b(dev) -> dict:
    """recurrentgemma-2b, 26 layers."""
    return serve_b(dev, SERVE_ARCH, SERVE_B, SERVE_B_LAUNCHES, "serve_b")


def phase_rwkv_serve_b(dev) -> dict:
    """rwkv6-1.6b, 24 layers."""
    return serve_b(dev, RWKV_ARCH, RWKV_SERVE_B, RWKV_SERVE_B_LAUNCHES,
                   "rwkv_serve_b")


def gmm_inputs(dev, e, c, d, f, dtype, seed):
    """Seeded standard-normal x ``(e, c, d)`` and w ``(e, d, f)`` on the
    card, drawn in ``dtype``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    return (torch.randn((e, c, d), generator=g, device=dev, dtype=dt),
            torch.randn((e, d, f), generator=g, device=dev, dtype=dt))


def gmm_plain(x, w):
    """The plain version, ``GMM_PLAIN_EXPERTS`` experts at a time."""
    out = torch.empty((x.shape[0], x.shape[1], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    for e0 in range(0, x.shape[0], GMM_PLAIN_EXPERTS):
        e1 = e0 + GMM_PLAIN_EXPERTS
        out[e0:e1] = grouped_matmul.grouped_matmul_ref(x[e0:e1], w[e0:e1])
    return out


def phase_gmm_kernel(dev) -> dict:
    """The grouped_matmul kernel against its plain version at every
    shape of ``GMM_SHAPES``."""
    gc.collect()                       # earlier phases' models
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = dict.fromkeys(GMM_TOL, 0.0)
    cases = []
    for i, ((e, c, d, f), dtype) in enumerate(GMM_SHAPES):
        x, w = gmm_inputs(dev, e, c, d, f, dtype, seed=i)
        out = grouped_matmul.grouped_matmul(x, w)
        ref = gmm_plain(x, w)
        torch.cuda.synchronize()
        what = f"{(e, c, d, f)} {dtype}"
        require(out.dtype == x.dtype and tuple(out.shape) == (e, c, f),
                f"{what}: output {out.dtype}{tuple(out.shape)}")
        rtol, atol = GMM_TOL[dtype]
        err = float((out.float() - ref.float()).abs().max())
        require(torch.allclose(out.float(), ref.float(), rtol=rtol,
                               atol=atol),
                f"{what}: kernel differs from plain by {err}")
        # a quarter of the slots, in reverse order, as a smaller batch
        # routes them: the same bits as in the full buffer
        some = torch.arange(max(c // 4, 1) - 1, -1, -1, device=x.device)
        require(torch.equal(grouped_matmul.grouped_matmul(
                    x[:, some].contiguous(), w), out[:, some]),
                f"{what}: slots computed in a smaller buffer differ")
        cases.append(dict(shape=(e, c, d, f), dtype=dtype, max_abs_err=err,
                          ref_max=float(ref.float().abs().max())))
        worst[dtype] = max(worst[dtype], err)
        del x, w, out, ref
    emit(phase="gmm_kernel", cases=cases, max_abs_err=worst,
         tolerance=GMM_TOL, equal=True, batch_invariant=True)
    return worst


def phase_moe_serve_a(dev) -> dict:
    """kimi-k2-1t-a32b, 2 layers (dense, MoE), 32 experts, f32."""
    return serve_a(dev, MOE_ARCH, MOE_SERVE_A, MOE_SERVE_A_LAUNCHES,
                   "moe_serve_a", MOE_DECODE_LAUNCHES, tokens_equal=True)


def phase_moe_serve_b(dev) -> dict:
    """kimi-k2-1t-a32b, 2 layers (dense, MoE), all 384 experts, bf16."""
    return serve_b(dev, MOE_ARCH, MOE_SERVE_B, MOE_SERVE_B_LAUNCHES,
                   "moe_serve_b", MOE_DECODE_LAUNCHES)


def phase_flash_window(dev) -> dict:
    """The flash kernel with a window and at 192/128 against its plain
    version at ``FLASH_WINDOW_SHAPES``; a window past the sequence gives
    the causal kernel's bits, one request alone its rows' bits in the
    batch."""
    gc.collect()                       # earlier phases' models
    torch.cuda.empty_cache()
    worst = dict.fromkeys(FLASH_TOL, 0.0)
    cases = []
    for i, (b, s, h, kv, hd, hdv, window, dtype) in enumerate(
            FLASH_WINDOW_SHAPES):
        q, k, v = flash_inputs(dev, b, s, s, h, kv, hd, dtype, 100 + i, hdv)
        out = flash_attention.flash_attention(q, k, v, window=window)
        ref = flash_attention.flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        what = f"{(b, s, h, kv, hd, hdv)} window={window} {dtype}"
        require(out.dtype == q.dtype and tuple(out.shape) == (b, s, h, hdv),
                f"{what}: output {out.dtype}{tuple(out.shape)}")
        rtol, atol = FLASH_TOL[dtype]
        err = float((out.float() - ref.float()).abs().max())
        require(torch.allclose(out.float(), ref.float(), rtol=rtol,
                               atol=atol),
                f"{what}: kernel differs from plain by {err}")
        if window >= s:
            require(torch.equal(out, flash_attention.flash_attention(
                q, k, v)), f"{what}: differs from the causal kernel")
        if b > 1:
            solo = flash_attention.flash_attention(
                q[-1:].contiguous(), k[-1:].contiguous(), v[-1:].contiguous(),
                window=window)
            require(torch.equal(solo, out[-1:]),
                    f"{what}: the last request alone differs from its rows "
                    f"in the batch")
        cases.append(dict(shape=(b, s, h, kv, hd, hdv), window=window,
                          dtype=dtype, max_abs_err=err,
                          ref_max=float(ref.float().abs().max())))
        worst[dtype] = max(worst[dtype], err)
        del q, k, v, out, ref
    emit(phase="flash_window", cases=cases, max_abs_err=worst,
         tolerance=FLASH_TOL, equal=True, batch_invariant=True,
         window_past_sequence_bit_equal=True)
    return worst


def phase_mla_serve_a(dev) -> dict:
    """deepseek-v3-671b, 2 layers (dense, MoE), 32 experts, f32."""
    return serve_a(dev, MLA_ARCH, MLA_SERVE_A, MLA_SERVE_A_LAUNCHES,
                   "mla_serve_a", MOE_DECODE_LAUNCHES, tokens_equal=True)


def phase_mla_serve_b(dev) -> dict:
    """deepseek-v3-671b, 4 layers (3 dense, 1 MoE), all 256 experts,
    bf16."""
    return serve_b(dev, MLA_ARCH, MLA_SERVE_B, MLA_SERVE_B_LAUNCHES,
                   "mla_serve_b", MOE_DECODE_LAUNCHES)


def phase_long_serve_a(dev) -> dict:
    """recurrentgemma-2b, one (rglru, rglru, local) unit, f32, prompts
    twice the window."""
    return serve_a(dev, SERVE_ARCH, LONG_SERVE_A, SERVE_A_LAUNCHES,
                   "long_serve_a")


def phase_long_serve_b(dev) -> dict:
    """recurrentgemma-2b, 26 layers, bf16, 6 144-token prompts."""
    return serve_b(dev, SERVE_ARCH, LONG_SERVE_B, SERVE_B_LAUNCHES,
                   "long_serve_b")


def frontend_feats(cfg, sa: dict) -> dict:
    """Seeded inputs of the frontend stub for ``sa["requests"]`` prompts,
    drawn N(0, 0.02^2) as the reference's ``make_batch`` draws them:
    the encoder's frame embeddings (B, encoder.seq_len, d) for
    ``frontend == "audio"``, the VLM's patch embeddings (B, num_patches,
    d) for ``"vlm"``."""
    rng = np.random.default_rng(sa["seed"])
    if cfg.frontend == "audio":
        name, n = "encoder_feats", cfg.encoder.seq_len
    else:
        name, n = "patch_embeds", cfg.num_patches
    return {name: (rng.standard_normal((sa["requests"], n, cfg.d_model))
                   * 0.02).astype(np.float32)}


def phase_whisper_serve_a(dev) -> dict:
    """whisper-large-v3, 2 encoder + 2 decoder layers, f32, seeded frame
    embeddings."""
    return serve_a(dev, WHISPER_ARCH, WHISPER_SERVE_A,
                   WHISPER_SERVE_A_LAUNCHES, "whisper_serve_a",
                   tokens_equal=True, frontend=frontend_feats)


def phase_whisper_serve_b(dev) -> dict:
    """whisper-large-v3, 32 + 32 layers, bf16."""
    return serve_b(dev, WHISPER_ARCH, WHISPER_SERVE_B,
                   WHISPER_SERVE_B_LAUNCHES, "whisper_serve_b")


def phase_phi_serve_a(dev) -> dict:
    """phi-3-vision-4.2b, 2 layers, f32, 256 seeded patches before 256
    text positions."""
    return serve_a(dev, PHI_ARCH, PHI_SERVE_A, PHI_SERVE_A_LAUNCHES,
                   "phi_serve_a", tokens_equal=True, frontend=frontend_feats)


def phase_phi_serve_b(dev) -> dict:
    """phi-3-vision-4.2b, 32 layers, bf16."""
    return serve_b(dev, PHI_ARCH, PHI_SERVE_B, PHI_SERVE_B_LAUNCHES,
                   "phi_serve_b")


def flash_bound(b, sq, skv, h, kv, hd, causal, dtype, window=0,
                hdv=None) -> dict:
    """The least time the card could take for one flash call: q, k, v
    read once (KV heads not repeated), o written once, over 3.35 TB/s;
    the products of the unmasked (query, key) pairs, 2 * hd flops each
    for S and 2 * hdv for P V, over the type's peak (causal: key j <= i;
    a window also i - j < window)."""
    hdv = hdv or hd
    size = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    n_bytes = (b * sq * h * (hd + hdv) + b * skv * kv * (hd + hdv)) * size
    pairs = (sum(min(i + 1, skv, window or skv) for i in range(sq))
             if causal else sq * skv)
    flops = 2 * (hd + hdv) * pairs * b * h
    peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return dict(bound_bytes=n_bytes, bound_flops=flops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_flash(dev, shape=FLASH_HEAD, window=0, hdv=None) -> dict:
    """The kernel, its plain version and ``scaled_dot_product_attention``
    (heads first, KV heads repeated; a band as a boolean mask; v at its
    own head dim) at ``shape``, with ``window`` and v's head dim."""
    b, sq, skv, h, kv, hd, causal, dtype = shape
    q, k, v = flash_inputs(dev, b, sq, skv, h, kv, hd, dtype, 5, hdv)
    # the library call's layout: heads first, KV heads repeated
    qs, ks, vs = (t.repeat_interleave(h // t.shape[2], dim=2)
                  .transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:
        i = torch.arange(sq, device=dev)[:, None]
        j = torch.arange(skv, device=dev)[None, :]
        band = (j <= i) & (i - j < window)
        library = lambda: sdpa(qs, ks, vs, attn_mask=band)   # noqa: E731
    else:
        library = lambda: sdpa(qs, ks, vs, is_causal=causal)  # noqa: E731
    launches = LAUNCHES["flash_attention"]
    rec = dict(shape=shape, window=window, hdv=hdv or hd,
               ms=device_ms(lambda: fa_kernel.flash_attention_cuda(
                   q, k, v, causal=causal, window=window), 20),
               plain_ms=device_ms(lambda: flash_attention.flash_attention_ref(
                   q, k, v, causal=causal, window=window), 10),
               library_ms=device_ms(library, 20),
               **flash_bound(*shape, window=window, hdv=hdv))
    LAUNCHES["flash_attention"] = launches     # timing runs are not counted
    return rec


def time_flash_window(dev, shape) -> dict:
    """``time_flash`` at a ``FLASH_WINDOW_SHAPES`` entry (causal)."""
    b, s, h, kv, hd, hdv, window, dtype = shape
    return time_flash(dev, (b, s, s, h, kv, hd, True, dtype), window, hdv)


def rglru_bound(t, b, w) -> dict:
    """The least time the card could take for one scan: a and x read
    once, h0 read once, h written once, over 3.35 TB/s; 2 flops per
    element over the f32 CUDA-core peak."""
    n_bytes = 12 * t * b * w + 4 * b * w
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2 * t * b * w / F32_FLOPS
    return dict(bound_bytes=n_bytes, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_rglru(dev) -> dict:
    """The wrapper on the model's (T, B, w) views (``ms``: the kernel and
    the zeroing of its look-back flags; ``kernel_ms``: the kernel alone),
    and on contiguous inputs."""
    t, b, w = RGLRU_HEAD
    a, x, h0 = rglru_inputs(dev, t, b, w, seed=5)
    am, xm = batch_major(a), batch_major(x)
    launches = LAUNCHES["rglru_scan"]
    rec = dict(shape=RGLRU_HEAD,
               ms=device_ms(lambda: rg_kernel.rglru_scan_cuda(am, xm, h0), 50),
               kernel_ms=device_ms(
                   lambda: rg_kernel.rglru_scan_cuda(am, xm, h0), 50,
                   "rglru_scan_kernel"),
               contiguous_ms=device_ms(
                   lambda: rg_kernel.rglru_scan_cuda(a, x, h0), 50),
               plain_ms=device_ms(lambda: rglru_scan.rglru_scan_ref(a, x, h0),
                                  3),
               library_ms=None, **rglru_bound(t, b, w))
    LAUNCHES["rglru_scan"] = launches          # timing runs are not counted
    return rec


def rwkv_bound(b, t, h, hd) -> dict:
    """The least time the card could take for one WKV call: r, k, v, w
    and u read once, out and the final state written once, over 3.35
    TB/s; the exact recurrence in its factored form, 5 * hd^2 + 4 * hd
    flops per (b, h, t) (sum_i r_i S_ij, S_ij = w_i S_ij + k_i v_j, and
    the bonus v_j * sum_i r_i u_i k_i), over the f32 CUDA-core peak."""
    n_bytes = 4 * (5 * b * t * h * hd + h * hd + b * h * hd * hd)
    flops = (5 * hd * hd + 4 * hd) * b * h * t
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return dict(bound_bytes=n_bytes, bound_flops=flops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_rwkv(dev) -> dict:
    ins = rwkv_inputs(dev, *RWKV_HEAD, RWKV_DECAYS[0], seed=5)
    launches = LAUNCHES["rwkv6_wkv"]
    rec = dict(shape=RWKV_HEAD,
               ms=device_ms(lambda: rw_kernel.wkv_cuda(*ins), 50),
               plain_ms=device_ms(lambda: rwkv6_wkv.wkv_ref(*ins), 2),
               library_ms=None, **rwkv_bound(*RWKV_HEAD))
    LAUNCHES["rwkv6_wkv"] = launches           # timing runs are not counted
    return rec


def gmm_bound(e, c, d, f, dtype) -> dict:
    """The least time the card could take for one grouped_matmul call: x
    and w read once, out written once, over 3.35 TB/s; 2 e c d f flops
    over the type's peak."""
    size = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    n_bytes = (e * c * d + e * d * f + e * c * f) * size
    flops = 2 * e * c * d * f
    peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return dict(bound_bytes=n_bytes, bound_flops=flops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_gmm(dev) -> list:
    """The kernel, its plain version (a few experts at a time) and
    ``torch.bmm`` on the same operands at each serve shape."""
    gc.collect()                       # the serve phases' models
    torch.cuda.empty_cache()
    launches = LAUNCHES["grouped_matmul"]
    recs = []
    for shape in GMM_SERVE:
        x, w = gmm_inputs(dev, *shape, "bfloat16", seed=5)
        recs.append(dict(
            shape=shape, dtype="bfloat16",
            ms=device_ms(lambda: gm_kernel.grouped_matmul_cuda(x, w), 10),
            plain_ms=device_ms(lambda: gmm_plain(x, w), 3),
            library_ms=device_ms(lambda: torch.bmm(x, w), 10),
            **gmm_bound(*shape, "bfloat16")))
        del x, w
    LAUNCHES["grouped_matmul"] = launches      # timing runs are not counted
    return recs


# ---- the training path (smollm-135m) -----------------------------------

def flash_bwd_check(dev, shape, seed, window=0) -> dict:
    """The forward with lse (o and lse) and the backward kernel against
    the plain versions at ``shape`` with ``window``, the backward on the
    forward kernel's o and lse; two launches bit for bit; the forward with
    lse bit for bit the forward without."""
    b, sq, skv, h, kv, hd, causal, dtype = shape
    q, k, v = flash_inputs(dev, b, sq, skv, h, kv, hd, dtype, seed)
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(seed + 1), device=dev).to(q.dtype)
    o, lse = fa_kernel.flash_attention_fwd_lse_cuda(q, k, v, causal=causal,
                                                    window=window)
    bare = fa_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
    got = fa_kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                             causal=causal, window=window)
    again = fa_kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                               causal=causal, window=window)
    torch.cuda.synchronize()
    what = f"{(b, sq, skv, h, kv, hd)} causal={causal} window={window} " \
        f"{dtype}"
    require(torch.equal(o, bare),
            f"{what}: the forward with lse differs from the one without")
    require(all(torch.equal(x, y) for x, y in zip(got, again)),
            f"{what}: two backward launches differ")
    o_ref, lse_ref = flash_attention.flash_attention_fwd_lse_ref(
        q, k, v, causal=causal, window=window)
    o_err = float((o.float() - o_ref.float()).abs().max())
    require(torch.allclose(o.float(), o_ref.float(), rtol=FLASH_TOL[dtype][0],
                           atol=FLASH_TOL[dtype][1]),
            f"{what}: the forward's o differs from the plain version's by "
            f"{o_err}")
    lse_err = float((lse - lse_ref).abs().max())
    require(lse_err <= FLASH_LSE_TOL[dtype],
            f"{what}: lse differs from the plain version's by {lse_err}")
    del o_ref, lse_ref
    want = flash_attention.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                   causal=causal,
                                                   window=window)
    rtol, atol = FLASH_BWD_TOL[dtype]
    errs, scales = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"{what}: {name} {g.dtype}{tuple(g.shape)}")
        gf, wf = g.float(), w.float()
        scales[name] = float(wf.abs().max())
        errs[name] = float((gf - wf).abs().max())
        require(bool(torch.isfinite(gf).all()) and torch.allclose(
            gf, wf, rtol=rtol, atol=atol * scales[name]),
            f"{what}: {name} differs from the plain version by "
            f"{errs[name]} (largest {scales[name]})")
    del want, got, again
    return dict(shape=shape, window=window, o_err=o_err, lse_err=lse_err,
                **errs, largest=scales)


def phase_flash_bwd_kernel(dev) -> dict:
    worst = dict.fromkeys(FLASH_BWD_TOL, 0.0)
    cases = []
    for i, (shape, window) in enumerate(
            [(sh, 0) for sh in FLASH_BWD_SHAPES] + list(FLASH_BWD_NEW)):
        rec = flash_bwd_check(dev, shape, 60 + i, window)
        cases.append(rec)
        worst[shape[-1]] = max(worst[shape[-1]], rec["dq"], rec["dk"],
                               rec["dv"])
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="flash_bwd_kernel", cases=cases, tolerance=FLASH_BWD_TOL,
         lse_tolerance=FLASH_LSE_TOL, max_abs_err=worst, equal=True,
         deterministic=True, lse_forward_bits_equal=True)
    return worst


def flash_bwd_bound(b, sq, skv, h, kv, hd, causal, dtype, window=0) -> dict:
    """The least time the card could take for one backward call: q, k, v,
    o, do and lse read once, dq, dk, dv written once, over 3.35 TB/s; the
    gradient's five products over the unmasked (query, key) pairs (S
    recomputed, dO V^T, P^T dO, dS K, dS^T Q; a window also hides i - j >=
    window), 2 hd flops each, over the type's peak.  Also the kernels' own
    bound: the seven products of the two-launch design (S and dO V^T in
    both launches), and each launch's share of them (dq three, dkdv
    four)."""
    size = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    n_bytes = (4 * b * sq * h * hd + 4 * b * skv * kv * hd) * size \
        + b * h * sq * 4
    pairs = (sum(min(i + 1, skv, window or skv) for i in range(sq)) if causal
             else sq * skv)
    product = 2 * hd * pairs * b * h           # flops of one product
    flops = 5 * product
    peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return dict(bound_bytes=n_bytes, bound_flops=flops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound7_flops=7 * product, bound7_ms=7 * product / peak * 1e3,
                bound7_dq_ms=3 * product / peak * 1e3,
                bound7_dkdv_ms=4 * product / peak * 1e3)


def time_flash_bwd(dev, shape=FLASH_BWD_HEAD, window=0,
                   reps: int = 10) -> dict:
    """The backward kernels' device time per call (both launches) and per
    launch (``dq_ms``, ``dkdv_ms``) at ``shape`` with ``window`` beside
    the plain version's, the bounds and the backward of
    ``scaled_dot_product_attention`` on the same tensors (heads first, KV
    heads repeated, a band as a boolean mask), timed alone; the forward
    kernel with lse and ``scaled_dot_product_attention``'s forward
    (``library_fwd_ms``)."""
    b, sq, skv, h, kv, hd, causal, dtype = shape
    q, k, v = flash_inputs(dev, b, sq, skv, h, kv, hd, dtype, seed=7)
    do = torch.randn(q.shape, device=dev).to(q.dtype)
    before = dict(LAUNCHES)
    o, lse = fa_kernel.flash_attention_fwd_lse_cuda(q, k, v, causal=causal,
                                                    window=window)

    def bwd():
        return fa_kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                  causal=causal,
                                                  window=window)
    rec = dict(shape=shape, window=window, ms=device_ms(bwd, reps),
               dq_ms=device_ms(bwd, reps, "dq_kernel"),
               dkdv_ms=device_ms(bwd, reps, "dkdv_kernel"),
               fwd_lse_ms=device_ms(
                   lambda: fa_kernel.flash_attention_fwd_lse_cuda(
                       q, k, v, causal=causal, window=window), reps),
               plain_ms=device_ms(lambda: flash_attention.
                                  flash_attention_bwd_ref(
                                      q, k, v, o, do, lse, causal=causal,
                                      window=window), 3),
               **flash_bwd_bound(*shape, window=window))
    gc.collect()
    torch.cuda.empty_cache()
    rec["library_fwd_ms"], rec["library_ms"] = sdpa_ms(q, k, v, do, causal,
                                                       window, reps)
    LAUNCHES.update(before)                 # timing runs are not counted
    return rec


def sdpa_ms(q, k, v, do, causal, window=0, reps: int = 10) -> tuple:
    """Device ms of ``scaled_dot_product_attention``'s forward and of its
    backward (``torch.autograd.grad``) on the kernels' ``(B, S, H, hd)``
    tensors, heads first and KV heads repeated (the copies not timed); a
    window as a boolean band mask."""
    h = q.shape[2]
    qs, ks, vs = (t.repeat_interleave(h // t.shape[2], dim=2)
                  .transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(is_causal=causal)
    if window:
        i = torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(k.shape[1], device=q.device)[None, :]
        kw = dict(attn_mask=(j <= i) & (i - j < window))
    fwd_ms = device_ms(lambda: sdpa(qs.detach(), ks.detach(), vs.detach(),
                                    **kw), reps)
    out = sdpa(qs, ks, vs, **kw)
    dos = do.transpose(1, 2).contiguous()
    bwd_ms = device_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True), reps)
    return fwd_ms, bwd_ms


def phase_train_a(dev) -> dict:
    """Full width, 2 layers, f32: the loss, every gradient leaf and the
    parameters after 2 AdamW steps on the card against the port's CPU run
    from the same weights and batches."""
    return train_a(dev, TRAIN_ARCH, TRAIN_A, "train_a", TRAIN_B_LAUNCHES)


def phase_rg_train_a(dev) -> dict:
    return train_a(dev, SERVE_ARCH, RG_TRAIN_A, "rg_train_a",
                   RG_TRAIN_B_LAUNCHES)


def phase_whisper_train_a(dev) -> dict:
    return train_a(dev, WHISPER_ARCH, WHISPER_TRAIN_A, "whisper_train_a",
                   WHISPER_TRAIN_B_LAUNCHES)


def adam_reach(opt_cfg, lrs: list, w0: float) -> float:
    """The most that AdamW under ``opt_cfg`` at the learning rates ``lrs``
    (one a step) moves a weight of magnitude at most ``w0``, over any
    gradients.  At step t the update is m/(sqrt(v) + eps) with bias-
    corrected m = sum_i c_i g_i and v = sum_i d_i g_i^2, so by Cauchy-
    Schwarz |m| <= sqrt(sum_i c_i^2 / d_i) sqrt(v); decay adds
    weight_decay |w|, and |w| grows by at most the moves before."""
    b1, b2, reach = opt_cfg.b1, opt_cfg.b2, 0.0
    for t, lr in enumerate(lrs, 1):
        step = math.sqrt(sum(
            ((1 - b1) * b1 ** (t - i) / (1 - b1 ** t)) ** 2
            / ((1 - b2) * b2 ** (t - i) / (1 - b2 ** t))
            for i in range(1, t + 1)))
        reach += lr * (step + opt_cfg.weight_decay * (w0 + reach))
    return reach


def train_a(dev, arch: str, ta: dict, phase: str, want: dict) -> dict:
    """``arch`` at full width, cut as ``ta`` says, f32: the loss, every
    gradient leaf and the parameters after ``ta["steps"]`` AdamW steps on
    the card against the port's CPU run from the same weights and batches
    (the pipeline's, frontend inputs included), within TRAIN_A_TOL; every
    kernel of ``want`` launched on the card."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = lm_cfg(arch, ta, param_dtype="float32", compute_dtype="float32")
    shape = ShapeSpec(phase, ta["seq"], ta["batch"], "train")
    tol = TRAIN_A_TOL
    opt_cfg = dataclasses.replace(
        optim.AdamWConfig(**TRAIN_OPT),
        state_dtype=cfg.parallel.opt_state_dtype, total_steps=10)
    card = build(cfg, dev).init(ta["seed"]).train_mode()
    cpu = build(cfg, "cpu").load_params(card.params()).train_mode()
    runs = {}
    t_cpu = 0.0
    for name, model, where in (("cpu", cpu, "cpu"), ("card", card, dev)):
        t0 = time.perf_counter()
        pipe = SyntheticPipeline(cfg, shape, device=where)
        reset_launches()
        loss, _ = model.loss(pipe.batch(0))
        loss.backward()
        loss = loss.detach()
        grads = [p.grad.detach().cpu().clone() for p in model.parameters()]
        for p in model.parameters():
            p.grad = None
        w0 = [float(p.detach().abs().max()) for p in model.parameters()]
        step = train_mod.make_train_step(model, opt_cfg)
        state = optim.init(opt_cfg, model.params())
        losses = []
        # the CPU's gradient elements within the gradient check's tolerance
        # of 0 at some step, by weight (see the parameter check)
        noise, update = {}, optim.update

        def noted(cfg_, grads_, state_, params_):
            for w, gr in zip(tree.leaves(params_), tree.leaves(grads_)):
                mag = gr.abs()
                near = mag <= tol["grad"] * mag.max()
                if id(w) in noise:
                    noise[id(w)].logical_or_(near)
                else:
                    noise[id(w)] = near
            return update(cfg_, grads_, state_, params_)
        if where == "cpu" and ta.get("excused"):
            optim.update = noted
        try:
            for i in range(ta["steps"]):
                state, met = step(state, pipe.batch(i))
                losses.append(float(met["loss"]))
        finally:
            optim.update = update
        runs[name] = dict(loss=loss.item(), grads=grads, losses=losses, w0=w0,
                          launches=dict(LAUNCHES),
                          noise=[noise.get(id(p)) for p in
                                 model.parameters()],
                          params=[p.detach().cpu() for p in
                                  model.parameters()])
        if name == "cpu":
            t_cpu = time.perf_counter() - t0
    c, g = runs["cpu"], runs["card"]
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip([g["loss"]] + g["losses"], [c["loss"]] + c["losses"]))
    require(loss_err <= tol["loss"],
            f"card losses {[g['loss']] + g['losses']} differ from the CPU's "
            f"{[c['loss']] + c['losses']} by {loss_err} (relative)")
    names = [n for n, _ in card.named_parameters()]
    grad_errs = {}
    for n, a, b in zip(names, g["grads"], c["grads"]):
        scale = float(b.abs().max())
        grad_errs[n] = float((a - b).abs().max()) / max(scale, 1e-30)
        require(bool(torch.isfinite(a).all())
                and grad_errs[n] <= tol["grad"],
                f"gradient {n}: card differs from CPU by {grad_errs[n]} of "
                f"its largest magnitude {scale}")
    lrs = [float(optim.schedule(opt_cfg, torch.tensor(i + 1)))
           for i in range(ta["steps"])]
    lr_sum = sum(lrs)
    share = ta.get("excused", 0.0)
    param_max, param_over, param_excused = 0.0, {}, {}
    for n, a, b, noise, w0 in zip(names, g["params"], c["params"], c["noise"],
                                  c["w0"]):
        d = (a - b).abs_()
        d_max = float(d.max())            # NaN or inf when either side is
        require(math.isfinite(d_max),
                f"parameter {n} after {ta['steps']} steps is not finite")
        param_max = max(param_max, d_max)
        over = int((d > 1e-5).sum())
        if over:
            param_over[n] = over
        if d_max <= tol["param"]:
            continue
        flat = d.view(-1)
        at = torch.nonzero(flat > tol["param"]).squeeze(1)
        require(bool(share), f"parameter {n} after {ta['steps']} steps: "
                f"{at.numel()} of {d.numel()} elements beyond "
                f"{tol['param']}, max {d_max}")
        bad = ~noise.view(-1)[at]
        require(not bool(bad.any()),
                f"parameter {n} after {ta['steps']} steps: {int(bad.sum())} "
                f"of {d.numel()} elements beyond {tol['param']} where the "
                f"gradient is not within its tolerance of 0, max "
                f"{float(flat[at][bad].max()) if bad.any() else 0.0}")
        # each side moves a weight at most adam_reach: the two at most twice
        bound = 2 * adam_reach(opt_cfg, lrs, w0)
        rec = dict(elements=at.numel(), numel=d.numel(),
                   share=at.numel() / d.numel(),
                   noise_share=int(noise.sum()) / d.numel(), max=d_max,
                   bound=bound)
        param_excused[n] = rec
        require(rec["share"] <= share and d_max <= bound,
                f"parameter {n} after {ta['steps']} steps: {at.numel()} of "
                f"{d.numel()} elements beyond {tol['param']} at near-zero "
                f"gradients (at most {share} of the leaf), max {d_max} (at "
                f"most {bound})")
    per_step = {k: g["launches"][k] for k in want}
    require(all(per_step.values()),
            f"the card's training launched {per_step}")
    emit(phase=phase, arch=arch, layers=cfg.num_layers,
         enc_layers=cfg.encoder.num_layers if cfg.encoder else None,
         d_model=cfg.d_model, vocab=cfg.vocab_size, dtype="float32",
         batch=ta["batch"], seq=ta["seq"], steps=ta["steps"],
         remat=cfg.parallel.remat, loss_cpu=[c["loss"]] + c["losses"],
         loss_card=[g["loss"]] + g["losses"], loss_rel_err=loss_err,
         grad_rel_err_max=max(grad_errs.values()),
         grad_rel_err=grad_errs, param_abs_err_max=param_max,
         params_beyond_1e5=param_over,
         params_excused=param_excused, excused_share_max=share,
         lr_sum=lr_sum,
         tolerance=tol, launches=per_step,
         cpu_seconds=t_cpu, equal=True)
    return dict(loss_err=loss_err, grad_err=max(grad_errs.values()))


def phase_train_b(dev) -> dict:
    """The training main path: smollm-135m at full width and depth (bf16,
    remat, f32 moments) through ``run_training``: 6 steps with a
    checkpoint every 3, then a run that crashes at step 4 and resumes,
    whose parameters and moments must equal the first run's bit for bit.
    Every step's launches, ms, the busy share of a profiled step and peak
    memory."""
    gc.collect()
    torch.cuda.empty_cache()
    tb = TRAIN_B
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("train_4k_cut", tb["seq"], tb["batch"], "train")
    root = ROOT / "build" / "train_b_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    records, made = [], train_mod.make_train_step

    def probed(*args, **kwargs):               # times each step of the runs
        fn = made(*args, **kwargs)

        def step(state, batch):
            torch.cuda.synchronize()
            before = dict(LAUNCHES)
            rec = dict(run=len(runs))
            t0 = time.perf_counter()
            if len(runs) == 0 and len(records) == 2:   # a steady step
                prof = {}

                def call():
                    prof["out"] = fn(state, batch)
                rec["profile"] = profile_call(call)
                out = prof["out"]
            else:
                out = fn(state, batch)
            torch.cuda.synchronize()
            rec.update(seconds=time.perf_counter() - t0,
                       loss=float(out[1]["loss"]),
                       launches={k: LAUNCHES[k] - before[k]
                                 for k in TRAIN_B_LAUNCHES})
            records.append(rec)
            return out
        return step

    runs = []
    kw = dict(cfg=cfg, shape=shape, steps=tb["steps"],
              ckpt_every=tb["ckpt_every"], log_every=100,
              opt=optim.AdamWConfig(**TRAIN_OPT), device="cuda")
    train_mod.make_train_step = probed
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        ref = train_mod.run_training(train_mod.TrainRun(
            ckpt_dir=str(root / "a"), **kw), resume=False)
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in TRAIN_B_LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        runs.append("a")
        run_b = train_mod.TrainRun(ckpt_dir=str(root / "b"), **kw)
        crashed = False
        try:
            train_mod.run_training(run_b, crash_at=tb["crash_at"])
        except RuntimeError as e:
            crashed = "simulated failure" in str(e)
        runs.append("b")
        resumed = train_mod.run_training(run_b, resume=True)
    finally:
        train_mod.make_train_step = made
        shutil.rmtree(root, ignore_errors=True)
    mismatch = [p for (p, a), (_, b) in zip(
        flatten({"p": ref["params"], "o": ref["opt_state"]}),
        flatten({"p": resumed["params"], "o": resumed["opt_state"]}))
        if not torch.equal(a, b)]
    first = [r for r in records if r["run"] == 0]
    losses = [r["loss"] for r in first]
    n_params = sum(p.numel() for p in tree.leaves(ref["params"]))
    require(crashed, "the run with crash_at did not fail as simulated")
    require(len(first) == tb["steps"]
            and len([r for r in records if r["run"] == 1]) == tb["crash_at"]
            and len([r for r in records if r["run"] == 2])
            == tb["steps"] - tb["ckpt_every"],
            f"steps per run: {[r['run'] for r in records]}")
    require(not mismatch, f"the resumed run differs from the uninterrupted "
                          f"one at {mismatch[:5]} ({len(mismatch)} leaves)")
    require(all(np.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"losses {losses}")
    require(all(r["launches"] == TRAIN_B_LAUNCHES for r in records),
            f"launches per step {[r['launches'] for r in records]}, want "
            f"{TRAIN_B_LAUNCHES}")
    steady = sorted(r["seconds"] for r in first[1:] if "profile" not in r)
    step_s = steady[len(steady) // 2]
    prof = next(r["profile"] for r in first if "profile" in r)
    tokens = tb["batch"] * tb["seq"]
    emit(phase="train_b", arch=TRAIN_ARCH, layers=cfg.num_layers,
         params=n_params, dtype=cfg.param_dtype,
         opt_state_dtype=cfg.parallel.opt_state_dtype,
         remat=cfg.parallel.remat, batch=tb["batch"], seq=tb["seq"],
         reduced={"global_batch": [256, tb["batch"]]},
         steps=tb["steps"], losses=losses,
         resumed_losses=[r["loss"] for r in records if r["run"] == 2],
         resume_bit_identical=True, leaves_compared=len(flatten(
             {"p": ref["params"], "o": ref["opt_state"]})),
         ms_per_step=step_s * 1e3,
         step_ms=[r["seconds"] * 1e3 for r in first],
         tokens_per_s=tokens / step_s, run_wall_s=wall,
         device_busy_share=prof["device_busy_share"], profile=prof,
         peak_memory_bytes=peak, launches=launches,
         launches_per_step=TRAIN_B_LAUNCHES)
    return dict(launches=launches, ms_per_step=step_s * 1e3)


def phase_rglru_bwd_kernel(dev) -> float:
    """The scan's gradient (``rglru_scan_bwd_cuda``: one launch over the
    reversed time axis, then the elementwise da and dh0) against its plain
    version (``rglru_scan_bwd_ref``) on the model's (T, B, w) views of
    (B, T, w) tensors, h from the forward kernel; two calls bit for
    bit."""
    worst = 0.0
    rtol, atol = RGLRU_TOL
    cases = []
    for i, (t, b, w) in enumerate(RGLRU_BWD_SHAPES):
        a, x, h0 = rglru_inputs(dev, t, b, w, 90 + i)
        a, x = batch_major(a), batch_major(x)
        h = rglru_scan.rglru_scan(a, x, h0)
        dh = batch_major(torch.randn((t, b, w), device=dev,
                                     generator=torch.Generator(device=dev)
                                     .manual_seed(95 + i)))
        before = LAUNCHES["rglru_scan_bwd"]
        got = rg_kernel.rglru_scan_bwd_cuda(a, h, h0, dh)
        again = rg_kernel.rglru_scan_bwd_cuda(a, h, h0, dh)
        torch.cuda.synchronize()
        require(LAUNCHES["rglru_scan_bwd"] == before + 2,
                f"{(t, b, w)}: {LAUNCHES['rglru_scan_bwd'] - before} "
                f"launches of the gradient's scan for two calls")
        require(all(torch.equal(g, a2) for g, a2 in zip(got, again)),
                f"{(t, b, w)}: two launches of the gradient differ")
        want = rglru_scan.rglru_scan_bwd_ref(a, h, h0, dh)
        errs = {}
        for name, g, wt in zip(("da", "db", "dh0"), got, want):
            errs[name] = float((g - wt).abs().max())
            require(g.shape == wt.shape and torch.allclose(
                g, wt, rtol=rtol, atol=atol * max(1.0, float(wt.abs().max()))),
                f"{(t, b, w)}: {name} differs from the plain version by "
                f"{errs[name]} (largest {float(wt.abs().max())})")
        worst = max(worst, *errs.values())
        cases.append(dict(shape=(t, b, w), **errs))
        del a, x, h, dh, got, again, want
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="rglru_bwd_kernel", cases=cases, layout="batch_major",
         max_abs_err=worst, tolerance=RGLRU_TOL, deterministic=True,
         equal=True)
    return worst


def rglru_bwd_bound(t, b, w) -> dict:
    """The least time the card could take for the scan's gradient: a, h
    and dh read once, h0 read once, da and db written once, dh0 written
    once, over 3.35 TB/s; 4 flops per element over the f32 peak."""
    n_bytes = 20 * t * b * w + 8 * b * w
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 4 * t * b * w / F32_FLOPS
    return dict(bound_bytes=n_bytes, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_rglru_bwd(dev) -> dict:
    """The gradient at ``RGLRU_BWD_HEAD`` on the model's views: ``ms``,
    the whole call (the reversed copies, the ordered scan, da and dh0);
    ``kernel_ms``, the scan kernel alone; the plain version's time."""
    t, b, w = RGLRU_BWD_HEAD
    a, x, h0 = rglru_inputs(dev, t, b, w, seed=7)
    a, x = batch_major(a), batch_major(x)
    h = rglru_scan.rglru_scan(a, x, h0)
    dh = batch_major(torch.randn((t, b, w), device=dev))
    before = dict(LAUNCHES)

    def call():
        return rg_kernel.rglru_scan_bwd_cuda(a, h, h0, dh)
    rec = dict(shape=RGLRU_BWD_HEAD, ms=device_ms(call, 20),
               kernel_ms=device_ms(call, 20, "rglru_scan_kernel"),
               plain_ms=device_ms(lambda: rglru_scan.rglru_scan_bwd_ref(
                   a, h, h0, dh), 2),
               library_ms=None, **rglru_bwd_bound(t, b, w))
    LAUNCHES.update(before)                 # timing runs are not counted
    return rec


def phase_rg_train_b(dev) -> dict:
    return train_main(dev, SERVE_ARCH, RG_TRAIN_B, RG_TRAIN_B_LAUNCHES,
                      "rg_train_b")


def phase_whisper_train_b(dev) -> dict:
    return train_main(dev, WHISPER_ARCH, WHISPER_TRAIN_B,
                      WHISPER_TRAIN_B_LAUNCHES, "whisper_train_b")


def phase_phi_train_b(dev) -> dict:
    return train_main(dev, PHI_ARCH, PHI_TRAIN_B, PHI_TRAIN_B_LAUNCHES,
                      "phi_train_b")


def train_main(dev, arch: str, tb: dict, want: dict, phase: str) -> dict:
    """A training main path: ``arch`` at full width (bf16, remat, f32
    moments; at full depth unless ``tb["layers"]`` cuts it) through
    ``run_training`` at ``NEW_TRAIN_OPT``, ``tb["steps"]`` steps on the
    pipeline's batches
    (frontend inputs included).  Every step launches each kernel exactly
    as ``want`` says (0 where it names none); the losses are finite and
    fall.  ms per step (the steps between the first and the last),
    tokens/s, the busy share of the last step (profiled), peak memory."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = lm_cfg(arch, tb)
    shape = ShapeSpec(phase, tb["seq"], tb["batch"], "train")
    records, made = [], train_mod.make_train_step

    def probed(*args, **kwargs):               # times each step of the run
        fn = made(*args, **kwargs)

        def step(state, batch):
            torch.cuda.synchronize()
            before = dict(LAUNCHES)
            rec = {}
            t0 = time.perf_counter()
            if len(records) == tb["steps"] - 1:        # the last step
                prof = {}

                def call():
                    prof["out"] = fn(state, batch)
                rec["profile"] = profile_call(call)
                out = prof["out"]
            else:
                out = fn(state, batch)
            torch.cuda.synchronize()
            rec.update(seconds=time.perf_counter() - t0,
                       loss=float(out[1]["loss"]),
                       grad_norm=float(out[1]["grad_norm"]),
                       launches={k: LAUNCHES[k] - before[k]
                                 for k in TRAIN_KERNELS})
            records.append(rec)
            return out
        return step

    train_mod.make_train_step = probed
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = train_mod.run_training(train_mod.TrainRun(
            cfg=cfg, shape=shape, steps=tb["steps"], log_every=100,
            opt=optim.AdamWConfig(**NEW_TRAIN_OPT), device="cuda"))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        train_mod.make_train_step = made
    n_params = sum(p.numel() for p in tree.leaves(out["params"]))
    del out
    gc.collect()
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in records]
    per_step = {k: want.get(k, 0) for k in TRAIN_KERNELS}
    require(len(records) == tb["steps"], f"{len(records)} steps")
    require(all(np.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"losses {losses}")
    require(all(r["launches"] == per_step for r in records),
            f"launches per step {[r['launches'] for r in records]}, want "
            f"{per_step}")
    steady = sorted(r["seconds"] for r in records[1:] if "profile" not in r)
    step_s = steady[len(steady) // 2]
    prof = records[-1]["profile"]
    tokens = tb["batch"] * tb["seq"]
    full = get_config(arch)
    reduced = {"global_batch": [SHAPES["train_4k"].global_batch,
                                tb["batch"]]}
    if cfg.num_layers != full.num_layers:
        reduced["num_layers"] = [full.num_layers, cfg.num_layers]
    emit(phase=phase, arch=arch, layers=cfg.num_layers,
         enc_layers=cfg.encoder.num_layers if cfg.encoder else None,
         params=n_params, dtype=cfg.param_dtype,
         opt_state_dtype=cfg.parallel.opt_state_dtype,
         remat=cfg.parallel.remat, batch=tb["batch"], seq=tb["seq"],
         reduced=reduced, steps=tb["steps"], opt=NEW_TRAIN_OPT,
         losses=losses,
         grad_norms=[r["grad_norm"] for r in records],
         ms_per_step=step_s * 1e3,
         step_ms=[r["seconds"] * 1e3 for r in records],
         tokens_per_s=tokens / step_s, run_wall_s=wall,
         device_busy_share=prof["device_busy_share"], profile=prof,
         peak_memory_bytes=peak, launches_per_step=per_step)
    return dict(launches={k: v * tb["steps"] for k, v in per_step.items()},
                launches_per_step=per_step, ms_per_step=step_s * 1e3)


def train_phases(dev) -> list:
    """The training paths' phases; their entries of the kernels line."""
    bwd_worst = timed(phase_flash_bwd_kernel, dev)
    rglru_bwd_worst = timed(phase_rglru_bwd_kernel, dev)
    timed(phase_train_a, dev)
    main_run = timed(phase_train_b, dev)
    timed(phase_rg_train_a, dev)
    timed(phase_whisper_train_a, dev)
    rg_run = timed(phase_rg_train_b, dev)
    whisper_run = timed(phase_whisper_train_b, dev)
    phi_run = timed(phase_phi_train_b, dev)
    t0 = time.perf_counter()
    bwd_t = time_flash_bwd(dev)
    new_t = [time_flash_bwd(dev, shape, window, reps=3)
             for shape, window in FLASH_BWD_TIMED]
    rglru_bwd_t = time_rglru_bwd(dev)
    emit(phase="train_kernel_time", seconds=time.perf_counter() - t0,
         flash_attention_bwd=bwd_t, flash_attention_bwd_new=new_t,
         rglru_scan_bwd=rglru_bwd_t)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    paths = {"train_b": main_run, "rg_train_b": rg_run,
             "whisper_train_b": whisper_run, "phi_train_b": phi_run}
    return [dict(name="flash_attention_bwd", route="cuda",
                 source="src/repro_torch/csrc/flash_attention_bwd.cu",
                 replaces="none: the reference differentiates plain "
                          "blocked_attention (src/repro/models/"
                          "attention.py:62) with XLA",
                 launches=main_run["launches"]["flash_attention_bwd_dq"]
                 + main_run["launches"]["flash_attention_bwd_dkdv"],
                 launches_by_kernel={
                     k: main_run["launches"][k]
                     for k in ("flash_attention_bwd_dq",
                               "flash_attention_bwd_dkdv")},
                 launches_per_step_by_path={
                     name: {k: run["launches_per_step"][k] for k in (
                         "flash_attention", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkdv")}
                     for name, run in paths.items() if name != "train_b"},
                 forward_launches=main_run["launches"]["flash_attention"],
                 max_abs_err=max(bwd_worst.values()),
                 **{k: bwd_t[k] for k in keys},
                 max_abs_err_by_dtype=bwd_worst, shape=bwd_t["shape"],
                 **{k: bwd_t[k] for k in ("dq_ms", "dkdv_ms", "bound7_ms",
                                          "bound7_dq_ms", "bound7_dkdv_ms",
                                          "fwd_lse_ms", "library_fwd_ms")},
                 instances=[{k: r[k] for k in keys + (
                     "shape", "window", "dq_ms", "dkdv_ms", "fwd_lse_ms",
                     "library_fwd_ms", "bound7_ms")} for r in new_t],
                 train_ms_per_step={name: run["ms_per_step"]
                                    for name, run in paths.items()}),
            dict(name="rglru_scan_bwd", route="cuda",
                 source="src/repro_torch/csrc/rglru_scan.cu",
                 replaces="none: the reference differentiates "
                          "lax.associative_scan (src/repro/models/"
                          "rglru.py:86) with XLA",
                 launches=rg_run["launches"]["rglru_scan_bwd"],
                 launches_per_step=rg_run["launches_per_step"][
                     "rglru_scan_bwd"],
                 forward_launches_per_step=rg_run["launches_per_step"][
                     "rglru_scan"],
                 max_abs_err=rglru_bwd_worst,
                 **{k: rglru_bwd_t[k] for k in keys},
                 kernel_ms=rglru_bwd_t["kernel_ms"],
                 shape=rglru_bwd_t["shape"])]


def lm_phases(dev) -> list:
    """The serve paths' phases; their entries of the kernels line."""
    flash_worst = timed(phase_flash_kernel, dev)
    rglru_worst = timed(phase_rglru_kernel, dev)
    timed(phase_serve_a, dev)
    main_run = timed(phase_serve_b, dev)
    rwkv_worst = timed(phase_rwkv_kernel, dev)
    timed(phase_rwkv_serve_a, dev)
    rwkv_run = timed(phase_rwkv_serve_b, dev)
    gmm_worst = timed(phase_gmm_kernel, dev)
    timed(phase_moe_serve_a, dev)
    moe_run = timed(phase_moe_serve_b, dev)
    window_worst = timed(phase_flash_window, dev)
    timed(phase_mla_serve_a, dev)
    mla_run = timed(phase_mla_serve_b, dev)
    timed(phase_long_serve_a, dev)
    long_run = timed(phase_long_serve_b, dev)
    timed(phase_whisper_serve_a, dev)
    whisper_run = timed(phase_whisper_serve_b, dev)
    timed(phase_phi_serve_a, dev)
    phi_run = timed(phase_phi_serve_b, dev)
    t0 = time.perf_counter()
    flash_t, rglru_t, rwkv_t = time_flash(dev), time_rglru(dev), \
        time_rwkv(dev)
    flash_moe_t, gmm_t = time_flash(dev, FLASH_MOE), time_gmm(dev)
    band_t = time_flash_window(dev, FLASH_BAND)
    mla_t = time_flash_window(dev, FLASH_MLA)
    enc_t, cross_t, hd96_t = (time_flash(dev, shape) for shape in (
        FLASH_ENCODER, FLASH_CROSS, FLASH_HD96))
    emit(phase="lm_kernel_time", seconds=time.perf_counter() - t0,
         flash_attention=flash_t, flash_attention_hd112=flash_moe_t,
         flash_attention_band=band_t, flash_attention_mla=mla_t,
         flash_attention_encoder=enc_t, flash_attention_cross=cross_t,
         flash_attention_hd96=hd96_t,
         rglru_scan=rglru_t, rwkv6_wkv=rwkv_t, grouped_matmul=gmm_t)
    flash_worst = {k: max(flash_worst[k], window_worst[k])
                   for k in flash_worst}
    gmm_head = next(r for r in gmm_t if r["shape"] == GMM_HEAD)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:22",
             launches=main_run["launches"]["flash_attention"],
             max_abs_err=max(flash_worst.values()),
             **{k: flash_t[k] for k in keys},
             max_abs_err_by_dtype=flash_worst, shape=flash_t["shape"],
             hd112={k: flash_moe_t[k] for k in keys + ("shape",)},
             band={k: band_t[k] for k in keys + ("shape", "window")},
             mla={k: mla_t[k] for k in keys + ("shape", "hdv")},
             encoder={k: enc_t[k] for k in keys + ("shape",)},
             cross={k: cross_t[k] for k in keys + ("shape",)},
             hd96={k: hd96_t[k] for k in keys + ("shape",)},
             launches_by_path={
                 "serve_b": main_run["launches"]["flash_attention"],
                 "moe_serve_b": moe_run["launches"]["flash_attention"],
                 "mla_serve_b": mla_run["launches"]["flash_attention"],
                 "long_serve_b": long_run["launches"]["flash_attention"],
                 "whisper_serve_b": whisper_run["launches"]["flash_attention"],
                 "phi_serve_b": phi_run["launches"]["flash_attention"]}),
        dict(name="rglru_scan", route="cuda",
             source="src/repro_torch/csrc/rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan/kernel.py:20",
             launches=main_run["launches"]["rglru_scan"],
             launches_long_serve_b=long_run["launches"]["rglru_scan"],
             max_abs_err=rglru_worst, **{k: rglru_t[k] for k in keys},
             shape=rglru_t["shape"], kernel_ms=rglru_t["kernel_ms"],
             contiguous_ms=rglru_t["contiguous_ms"]),
        dict(name="rwkv6_wkv", route="cuda",
             source="src/repro_torch/csrc/rwkv6_wkv.cu",
             replaces="src/repro/kernels/rwkv6_wkv/kernel.py:24",
             launches=rwkv_run["launches"]["rwkv6_wkv"],
             max_abs_err=rwkv_worst, **{k: rwkv_t[k] for k in keys},
             shape=rwkv_t["shape"]),
        dict(name="grouped_matmul", route="cuda",
             source="src/repro_torch/csrc/grouped_matmul.cu",
             replaces="src/repro/kernels/grouped_matmul/kernel.py:17",
             launches=moe_run["launches"]["grouped_matmul"],
             launches_mla_serve_b=mla_run["launches"]["grouped_matmul"],
             max_abs_err=max(gmm_worst.values()),
             **{k: gmm_head[k] for k in keys},
             max_abs_err_by_dtype=gmm_worst, shape=gmm_head["shape"],
             dtype=gmm_head["dtype"],
             other_shapes=[{k: r[k] for k in keys + ("shape",)}
                           for r in gmm_t if r is not gmm_head])]


def timed(phase, *args):
    """Run one phase and report its wall seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit(phase=f"{phase.__name__}_seconds", seconds=time.perf_counter() - t0)
    return out


def setup():
    """The device record and the build of every kernel; the card, or
    None when torch sees no CUDA device."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return None
    dev = torch.device("cuda")
    smi = smi_line()
    print(smi, flush=True)
    CARD["card"] = smi
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:    # one nvcc each
        builds = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for mod in (es_kernel, cs_kernel, fa_kernel, rg_kernel, rw_kernel,
                gm_kernel):
        mod._launcher()
    fa_kernel._lse_launcher()
    fa_kernel._bwd_launchers()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries={k: Path(v["path"]).name for k, v in builds.items()},
         ptxas={k: [ln.strip() for ln in v["log"].splitlines()
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln]
                for k, v in builds.items()})
    return dev


def main() -> int:
    t_start = time.perf_counter()
    dev = setup()
    if dev is None:
        return 1
    smi = CARD["card"]

    worst = timed(phase_kernel, dev)
    mc_run = timed(phase_model_check, dev)
    run_check = timed(phase_run_kernel, dev)
    scatter_worst = timed(phase_scatter_kernel, dev)
    lm_kernels = lm_phases(dev)
    train_kernels = train_phases(dev)
    timed(phase_exact, dev)
    timed(phase_golden)
    main_run = timed(phase_main)
    trace_run = timed(phase_trace, main_run["points"])
    timed(phase_profile)
    sweep_run = timed(phase_sweep)
    fig4_run = timed(phase_fig4)
    hier_run = timed(phase_hier)
    hier_time = timed(phase_hier_time)
    fig6_run = timed(phase_fig6)
    grid_run = timed(phase_workloads)
    program_time = timed(phase_program_time)
    fig3_skew_run = timed(phase_fig3_skew)
    topo_run = timed(phase_topology, dev)
    topo_time = timed(phase_topo_time)
    faults_run = timed(phase_faults)
    fault_time = timed(phase_fault_time)

    t0 = time.perf_counter()
    runs = [time_run(full_width_spec(*pt), plain=i == 0)
            for i, pt in enumerate(FULL_WIDTH_POINTS)]
    emit(phase="run_time", seconds=time.perf_counter() - t0, points=runs)
    locks = [time_run(full_width_spec(*pt), plain=False)
             for pt in LOCK_TIME_POINTS]
    emit(phase="lock_time", points=[
        {k: r[k] for k in ("protocol", "n", "a", "cycles", "ms",
                           "us_per_cycle", "barrier_floor_ms",
                           "barriers_per_cycle", "bound_ms")}
        for r in locks])
    head = runs[0]
    kernels = [dict(
        name="engine_run", route="cuda",
        source="src/repro_torch/csrc/engine_step.cu",
        replaces="src/repro/kernels/engine_step/kernel.py:45",
        launches=main_run["launches"],
        max_abs_err=max(run_check["max_abs_err"], head["max_abs_err"],
                        topo_run["max_abs_err"]),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "us_per_cycle",
                                "barrier_floor_ms", "barriers_per_cycle",
                                "threads")},
        shape=dict(protocol=head["protocol"], n=head["n"], a=head["a"],
                   cycles=head["cycles"]),
        batched=dict(
            sweep_fig3_launches=sweep_run["fig3_launches"],
            sweep_mixed_launches=sweep_run["mixed_launches"],
            fig3_study_wall_s=min(sweep_run["fig3"]["study_wall_s_repeat"]),
            fig3_single_walls_sum_s=sweep_run["fig3"]["single_walls_sum_s"],
            fig3_busy_share=sweep_run["fig3"]["device_busy_share"],
            by_b=[{k: r[k] for k in ("b", "ms", "ms_per_point", "wall_ms",
                                     "wall_ms_per_point", "barrier_floor_ms",
                                     "bound_ms")}
                  for r in sweep_run["batches"]],
            occupancy=sweep_run["occupancy"]),
        fig4=dict(launches=fig4_run["launches"], points=fig4_run["points"],
                  card_ms=fig4_run["card_ms"],
                  study_wall_s=fig4_run["study_wall_s"],
                  single_walls_sum_s=fig4_run["single_walls_sum_s"],
                  busy_share=fig4_run["device_busy_share"]),
        hier=dict(launches=hier_run["launches"], points=hier_run["points"],
                  card_ms=hier_run["card_ms"],
                  study_wall_s=hier_run["study_wall_s"],
                  single_walls_sum_s=hier_run["single_walls_sum_s"],
                  busy_share=hier_run["device_busy_share"]),
        fig6=dict({k: fig6_run[k] for k in (
            "launches", "points", "card_ms", "card_ms_per_launch",
            "study_wall_s", "single_walls_sum_s", "headline")},
            busy_share=fig6_run["device_busy_share"]),
        workloads=dict({k: grid_run[k] for k in (
            "launches", "points", "card_ms", "study_wall_s",
            "single_walls_sum_s", "colibri_over_lrsc")},
            busy_share=grid_run["device_busy_share"]),
        fig3_skew=dict({k: fig3_skew_run[k] for k in (
            "launches", "points", "card_ms", "study_wall_s",
            "single_walls_sum_s", "zipf15_colibri_over_lrsc_1024bins")},
            busy_share=fig3_skew_run["device_busy_share"]),
        topology=dict({k: topo_run[k] for k in (
            "launches", "points", "card_ms", "card_ms_per_launch",
            "study_wall_s", "single_walls_sum_s", "headline")},
            busy_share=topo_run["device_busy_share"]),
        us_per_cycle_topology_256x4={
            k: r["us_per_cycle"] for k, r in topo_time["topology"].items()},
        us_per_cycle_zipf_256x1024={
            k: r["us_per_cycle"] for k, r in topo_time["zipf"].items()},
        occupancy_topology=topo_time["occupancy"],
        faults=dict({k: faults_run[k] for k in (
            "launches", "points", "card_ms", "study_wall_s",
            "single_walls_sum_s", "headline")},
            busy_share=faults_run["device_busy_share"]),
        us_per_cycle_faults_256x1={
            k: r["us_per_cycle"] for k, r in fault_time["points"].items()},
        occupancy_fault=fault_time["occupancy"],
        us_per_cycle_programs_256={
            f"{r['workload']}/{r['protocol']}": r["us_per_cycle"]
            for r in program_time["points"]},
        occupancy_program=program_time["occupancy"],
        us_per_cycle_256x1=dict(
            {r["protocol"]: r["us_per_cycle"] for r in locks},
            **{r["protocol"]: r["us_per_cycle"]
               for r in hier_time["points"]}),
        occupancy=hier_time["occupancy"])]
    timing = [time_kernel(dev, "colibri", 256, 1),
              time_kernel(dev, "lrsc", 256, 256),
              time_kernel(dev, "colibri", 1024, 1)]
    head = timing[0]
    emit(phase="kernel_time", shapes=timing)
    kernels.append(dict(
        name="engine_step", route="cuda",
        source="src/repro_torch/csrc/engine_step.cu",
        replaces="src/repro/kernels/engine_step/kernel.py:45",
        launches=main_run["step_launches"],
        plain_loop_launches=run_check["plain_launches"],
        model_check_launches=mc_run["launches"],
        model_check_seconds=mc_run["seconds"],
        max_abs_err=worst,
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=None, call_ms=head["call_ms"],
        plain_call_ms=head["plain_call_ms"],
        shape=dict(protocol=head["protocol"], n=head["n"], a=head["a"])))
    t0 = time.perf_counter()
    scatter_times = [time_scatter(dev, *shape) for shape in SCATTER_SHAPES]
    t, bins = SCATTER_SKEW
    skew = time_scatter(dev, t, bins, 1, "float32", keys=torch.from_numpy(
        skewed_keys(t, bins, seed=41)).to(dev))
    streams = time_trace_streams(dev, trace_run["streams"])
    floor = launch_floor_ms(dev)
    emit(phase="scatter_time", seconds=time.perf_counter() - t0,
         shapes=scatter_times, skewed=skew, trace_streams=streams,
         floor_ms=floor)
    head = next(r for r in scatter_times
                if (r["t"], r["bins"], r["d"], r["dtype"]) == SCATTER_HEAD)
    kernels.append(dict(
        name="colibri_scatter", route="cuda",
        source="src/repro_torch/csrc/colibri_scatter.cu",
        replaces="src/repro/kernels/colibri_scatter/kernel.py:29",
        launches=trace_run["launches"]["colibri_scatter"],
        max_abs_err=max(scatter_worst.values()),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=head["library_ms"],
        bincount_ms=head["bincount_ms"], op_ms=head["op_ms"],
        floor_ms=floor,
        trace_stream_ms={r["point"]: r["ms"] for r in streams},
        skewed_ms=skew["ms"], max_abs_err_by_dtype=scatter_worst,
        shape=dict(t=head["t"], bins=head["bins"], d=head["d"],
                   dtype=head["dtype"])))
    kernels += lm_kernels + train_kernels
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
