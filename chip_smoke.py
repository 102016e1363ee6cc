#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the whole check, one NVIDIA GPU

Phases, one JSON line each:

1. device — needs ``torch.cuda.is_available()``; prints ``nvidia-smi``'s
   name and power limit of the card;
2. build — compiles the ``engine_step``, ``colibri_scatter``,
   ``flash_attention`` and ``rglru_scan`` CUDA kernels from the
   checkout, one ``nvcc`` each, in parallel;
3. kernel — the engine_step kernel against its plain PyTorch version on
   the card, for each protocol at every (cores, banks) shape the later
   phases give it, plus the reference's multi-tile case, over chained
   cycles from seeded random states: every output and bank array must
   be equal;
4. scatter_kernel — the colibri_scatter kernel against its plain
   version on the card at the reference tests' shapes (f32 and bf16),
   the trace path's shapes and two large ones: float sums within
   ``tests/test_kernels.py``'s tolerances, histograms exact (also
   against ``torch.bincount``), keys equal to ``bins`` dropped;
5. the LM serve path (recurrentgemma-2b):
   flash_kernel / rglru_kernel — each kernel against its plain version
   on the card at the reference tests' shapes and the serve shapes,
   within ``tests/test_kernels.py``'s tolerances;
   serve_a — full width, one (rglru, rglru, local) unit, f32 weights
   seeded on the card and copied to the CPU: the card's prefill and
   decode logits, teacher-forced on the CPU engine's greedy tokens,
   within ``SERVE_A_TOL`` of the port's CPU logits;
   serve_b — the slice's main path: full width and depth, bf16, four
   512-token requests and 16 new tokens each through ``ServeEngine``;
   exactly 8 flash_attention and 18 rglru_scan launches in the
   prefill and none in decode, finite logits, prefill ms, decode ms
   per token, peak memory, a profile of one prefill and one decode
   step; lm_kernel_time — both kernels' device time at the serve
   shapes beside their bounds, their plain versions and (flash)
   ``scaled_dot_product_attention``;
6. exact — ``zipf_index`` (skew 0) and ``_hash`` on the card against the
   CPU over 2^24 inputs;
7. golden — ``repro_torch.sync.run`` on the card reproduces the
   reference's golden values (``tests/test_protocols.py``), and one point
   per protocol equals the port's own CPU run key for key;
8. main path — the paper's 256-core MemPool at 20 000 cycles (Fig. 3
   histogram, uniform bins) for colibri and lrsc at 1 and 256 bins, and
   a 1024-core colibri point: summaries and metrics equal the
   reference's values below, and the kernel ran once per cycle;
9. trace path — the four 256-core points again with ``record_trace``
   and 64 telemetry windows: the traces, telemetry, exact-waits latency
   percentiles, ``trace_latency_hist`` (one colibri_scatter launch),
   span counts and, at one bin, the Perfetto JSON equal the reference's
   values below; colibri shows no BACKOFF span and no poll, lrsc shows
   BACKOFF spans; wall time beside the same point untraced;
10. profile — device time by kernel over 300 cycles of the main path
   (``torch.profiler``), untraced and traced: kernels per cycle, device
   busy share;
11. kernel times — each kernel's device time per call (profiler) beside
   its bound, its plain version's and the PyTorch library call's, at
   the shapes the paths give it; the kernels line.

The reference values below were computed with the JAX package
(``repro``); ``tests/test_torch_sync.py`` and
``tests/test_torch_trace_values.py`` recompute them so they cannot
drift.  The script imports neither JAX nor ``repro``.  It exits non-zero
when any phase fails, and its last line is the device record.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import metrics, protocols, sim  # noqa: E402
from repro_torch.core.workloads.base import zipf_index  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels import colibri_scatter, engine_step  # noqa: E402
import repro_torch.kernels.colibri_scatter.kernel as cs_kernel  # noqa: E402
from repro_torch.kernels.engine_step import kernel as es_kernel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention, rglru_scan  # noqa: E402
import repro_torch.kernels.flash_attention.kernel as fa_kernel  # noqa: E402
import repro_torch.kernels.rglru_scan.kernel as rg_kernel  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.obs import perfetto  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.obs.schema import STATE_NAMES  # noqa: E402
from repro_torch.sync import Spec, run  # noqa: E402

PROTOS = ("amo", "lrsc", "lrscwait", "colibri")

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
}
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
#: (protocol, cores, bins) at SimParams defaults (20 000 cycles),
#: zipf_histogram with zipf_skew=0 (uniform bins)
FULL_WIDTH_POINTS = (("colibri", 256, 1), ("colibri", 256, 256),
                     ("lrsc", 256, 1), ("lrsc", 256, 256),
                     ("colibri", 1024, 1))
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
    "backoff_cyc": 0, "bank_ops": 301035, "net_stall": 535, "ops_min":
    587, "ops_max": 588, "lat_hist_sum": 150414, "lat_max": 38,
    "throughput": 7.5207, "jain_fairness": 0.9999992844889197,
    "energy_pj_per_op": 3.006174464066015},
 "lrsc/256/1": {
    "ops": 202, "msgs": 39990, "polls": 9773, "sleep_cyc": 0,
    "backoff_cyc": 3181329, "bank_ops": 19995, "net_stall": 0,
    "ops_min": 0, "ops_max": 5, "lat_hist_sum": 202, "lat_max": 19917,
    "throughput": 0.0101, "jain_fairness": 0.3777029028436019,
    "energy_pj_per_op": 847.9332441822619},
 "lrsc/256/256": {
    "ops": 122101, "msgs": 504118, "polls": 3847, "sleep_cyc": 0,
    "backoff_cyc": 873078, "bank_ops": 252059, "net_stall": 16,
    "ops_min": 310, "ops_max": 576, "lat_hist_sum": 122101, "lat_max":
    2730, "throughput": 6.10505, "jain_fairness": 0.9909470155320287,
    "energy_pj_per_op": 3.0730100606274298},
 "colibri/1024/1": {
    "ops": 1266, "msgs": 14218, "polls": 0, "sleep_cyc": 19913121,
    "backoff_cyc": 0, "bank_ops": 3555, "net_stall": 11595, "ops_min":
    1, "ops_max": 2, "lat_hist_sum": 1266, "lat_max": 16357,
    "throughput": 0.0633, "jain_fairness": 0.8943950892857143,
    "energy_pj_per_op": 519.8547404268566},
}


#: (cores, banks) of the kernel-vs-plain phase: every shape the golden and
#: main-path phases launch the kernel at, plus (256, 64), (1024, 256) and
#: the reference's multi-tile case (2048, 512)
KERNEL_SHAPES = tuple(sorted(
    {(c["n_cores"], c["n_addrs"]) for c in GOLDEN_CONFIGS}
    | {(c["n_cores"], c["n_addrs"]) for c, _ in GOLDEN_EXTRA.values()}
    | {(n, bins) for _, n, bins in FULL_WIDTH_POINTS}
    | {(256, 64), (1024, 256), (2048, 512)}))


# ---- the trace path: the main path's 256-core points, traced ---------
#: (protocol, cores, bins) of the trace phase, each with record_trace and
#: 64 telemetry windows at 20 000 cycles
TRACE_POINTS = FULL_WIDTH_POINTS[:4]
#: points whose Perfetto JSON is hashed (8 617 and 60 273 spans); at 256
#: bins (~0.9 M spans) the span counts are compared instead
PERFETTO_HASHED = (("colibri", 256, 1), ("lrsc", 256, 1))
#: result arrays hashed (sha256 of their bytes in this dtype, C order)
TRACE_ARRAYS = {"trace_step": "<i4", "trace_wait": "<i4",
                "trace_state": "i1", "trace_qlen": "<i4", "tele": "<i4"}
#: the reference's values for those points (repro.sync.run, xla_cpu,
#: repro.core.metrics.trace_latency_hist, repro.obs), as trace_record
#: computes them
TRACE_REF = {
 "colibri/256/1": {
    "ops": 1316, "msgs": 11546, "polls": 0, "sleep_cyc": 5047667,
    "backoff_cyc": 0, "bank_ops": 2887, "net_stall": 0, "ops_min": 5,
    "ops_max": 6, "lat_hist_sum": 1316, "lat_max": 4082, "throughput":
    0.0658, "jain_fairness": 0.9954476898175397, "energy_pj_per_op":
    121.97751835945519, "lat_p50": 3830.0, "lat_p95": 3830.0,
    "trace_step_sha256":
        "0472fb9ba51890d1204a45ce08b86968ff13c5d81342ab8e338acddd533f8bf4",
    "trace_wait_sha256":
        "e22a87a754792560c5f7357b031f9354de5696938d9f4f611e6088e8cab1c36a",
    "trace_state_sha256":
        "d677b874ff22e43f38428b69a60c4a3d44a5d8481e96cf2f5c4889b754e280ec",
    "trace_qlen_sha256":
        "744651736fa82604c2ae59556eb8d66ed5b894de5742acfe0f91052a589d33bf",
    "tele_sha256":
        "2db73807f512e4143718fcff946904ce260f6974285dacde97f6efc4b0f27cdb",
    "trace_latency_hist": [
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 4, 4, 6, 6, 8, 9, 11, 13, 15, 19, 21,
        26, 31, 37, 1103, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "spans": {
        "WORK": 1525, "REQ": 2888, "SLEEP": 1570, "MOD": 1317, "BACKOFF": 0,
        "RESP": 1317, "BARWAIT": 0},
    "perfetto_sha256":
        "715dd8c10d961d637e6d76d5413fc6ff1e3eac5e81c0aed336ab703f9cdd1364"},
 "colibri/256/256": {
    "ops": 150414, "msgs": 603226, "polls": 0, "sleep_cyc": 3178,
    "backoff_cyc": 0, "bank_ops": 301035, "net_stall": 535, "ops_min": 587,
    "ops_max": 588, "lat_hist_sum": 150414, "lat_max": 38, "throughput":
    7.5207, "jain_fairness": 0.9999992844889197, "energy_pj_per_op":
    3.006174464066015, "lat_p50": 24.0, "lat_p95": 24.0,
    "trace_step_sha256":
        "5ea0a2c42027bc3ca05ff92ea94cf0316b6f61c52c7c0eea582ea89d51ab2f6a",
    "trace_wait_sha256":
        "028ab26218e33ea9de1038afc236d5d01f5530dcc9a5fdfb7e037949122ce7cc",
    "trace_state_sha256":
        "8b05f50cc8cd76387f7b6dbaa6a7ca93e5d44e31b973cdbc18646543a860696e",
    "trace_qlen_sha256":
        "504adf6635753e78041e533bb9ccf0003a9b31d0a82d6c6d4662b109a44c2434",
    "tele_sha256":
        "7406384caa464eb3bbd61a3bf20356458fd54194df9818dd55bd636df3843df1",
    "trace_latency_hist": [
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 150020, 257,
        136, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "spans": {
        "WORK": 150623, "REQ": 301160, "SLEEP": 289, "MOD": 150528,
        "BACKOFF": 0, "RESP": 300746, "BARWAIT": 0}},
 "lrsc/256/1": {
    "ops": 202, "msgs": 39990, "polls": 9773, "sleep_cyc": 0, "backoff_cyc":
    3181329, "bank_ops": 19995, "net_stall": 0, "ops_min": 0, "ops_max": 5,
    "lat_hist_sum": 202, "lat_max": 19917, "throughput": 0.0101,
    "jain_fairness": 0.3777029028436019, "energy_pj_per_op":
    847.9332441822619, "lat_p50": 6978.0, "lat_p95": 17713.0,
    "trace_step_sha256":
        "3cb813ad0398380e0c05ff742e8df01799b1223bc7f30ac0a934ede3e3ac84f5",
    "trace_wait_sha256":
        "e87103c805e61929829d71c35251765092083853850b8e67d4f24eda1806f18b",
    "trace_state_sha256":
        "85e74384d71cbb448ba9a893bdbee51d0899cdc5c0aec0d2885c5183ac838af3",
    "trace_qlen_sha256":
        "f8c784aa6b57396e7c5e094c34d079d8252473e46e2f60593a921dbebf941fcc",
    "tele_sha256":
        "83d730a3a1016ebf8105d4179b4f6f26ced0fce20360211f5391947f980e8fad",
    "trace_latency_hist": [
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 1, 0, 5, 19, 0, 2, 1, 0, 2, 0, 0, 1, 1, 8, 2, 2, 4, 4,
        6, 7, 7, 9, 6, 13, 18, 17, 18, 17, 17, 14, 1, 0, 0, 0, 0, 0, 0],
    "spans": {
        "WORK": 411, "REQ": 20079, "SLEEP": 0, "MOD": 10017, "BACKOFF":
        9771, "RESP": 19995, "BARWAIT": 0},
    "perfetto_sha256":
        "540e540d0a5c41665f8aa90126716b1c7a0b8a0c72c542f9eefba84fdecdc030"},
 "lrsc/256/256": {
    "ops": 122101, "msgs": 504118, "polls": 3847, "sleep_cyc": 0,
    "backoff_cyc": 873078, "bank_ops": 252059, "net_stall": 16, "ops_min":
    310, "ops_max": 576, "lat_hist_sum": 122101, "lat_max": 2730,
    "throughput": 6.10505, "jain_fairness": 0.9909470155320287,
    "energy_pj_per_op": 3.0730100606274298, "lat_p50": 24.0, "lat_p95": 24.0,
    "trace_step_sha256":
        "6a57e447d8fde94c1f89fc887854ff97bc264da84f647c3db5e0b86b62e88751",
    "trace_wait_sha256":
        "83cf7fc7d9687a5bc65f74a5d80fc60c4fc8e0b61ef7415e555aa9b2bf6002c3",
    "trace_state_sha256":
        "4de5fe6d6d6ddd77086f5695e3e513d9e7c54f5c2f74b7a069e4014e52beecc5",
    "trace_qlen_sha256":
        "99bc76fe79fcfd5e5baf554639fed136ae926dbc105e2e09e70e34f497af1dcb",
    "tele_sha256":
        "16bcffab30d539de5df811a84460d9d697e7ba6f331e3b904b6aea03b27a3942",
    "trace_latency_hist": [
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 119585, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 400, 1266, 0, 0, 0, 0, 571, 11, 0, 188,
        0, 49, 20, 8, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0],
    "spans": {
        "WORK": 122310, "REQ": 252105, "SLEEP": 0, "MOD": 126030, "BACKOFF":
        3847, "RESP": 252059, "BARWAIT": 0}}}

# ---- the colibri_scatter kernel -----------------------------------------
#: (T, bins, d, dtype) of the scatter_kernel phase: the reference tests'
#: shapes in both dtypes (513 x 1 x 4: the whole stream in one bin), the
#: trace path's (its four points' completion counts into the 64 latency
#: bins) and two large cases
SCATTER_SHAPES = tuple(
    [(t, b, d, dt) for dt in ("float32", "bfloat16")
     for t, b, d in ((100, 7, 1), (1000, 64, 8), (2048, 300, 16),
                     (513, 1, 4))]
    + [(t, 64, 1, "float32") for t in (150_414, 122_101, 1_316, 202)]
    + [(1 << 20, 64, 1, "float32"), (1 << 16, 1024, 128, "float32")])
#: dtype -> (rtol, atol), tests/test_kernels.py's
SCATTER_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (0.15, 1.5)}
#: the trace path's largest shape: the kernels line's times
SCATTER_HEAD = (150_414, 64, 1, "float32")

# ---- the LM serve path: recurrentgemma-2b through ServeEngine ---------
SERVE_ARCH = "recurrentgemma-2b"
#: (b, sq, skv, h, kv, hd, causal, dtype) of the flash_kernel phase: the
#: reference tests' shapes (tests/test_kernels.py, causal only where
#: sq == skv) in both dtypes, the smoke config's head dim 32, head dim
#: 256 in f32, and the serve path's prefill shapes (phase serve_a: two
#: 256-token prompts, f32; serve_b: four 512-token prompts, bf16, also
#: in f32 to hold its long rows to the f32 tolerance)
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
       (4, 512, 512, 10, 1, 256, True, "bfloat16")])
#: dtype -> (rtol, atol) of the kernel against its plain version on the
#: card.  f32: tests/test_kernels.py's.  bf16: both sum in f32 and round
#: the output to bf16 once, so they differ by about one bf16 rounding of
#: o (worst 1.95e-3 on an H100); 1e-2 is about 5x that and well under
#: the typical |o| of 0.07-0.1 at these shapes, so a dropped key tile or
#: a mis-rescaled accumulator shows.  (The CPU tests against the Pallas
#: kernel keep tests/test_kernels.py's 2e-2 / 1e-1.)
FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}
#: the serve path's full-depth prefill shape: the kernels line's times
FLASH_HEAD = FLASH_SHAPES[-1]
#: (T, B, w) of the rglru_kernel phase: the reference tests' shapes and
#: the serve path's (serve_a: 256 x 2, serve_b: 512 x 4, width 2560)
RGLRU_SHAPES = ((64, 2, 128), (100, 3, 60), (256, 1, 256), (256, 2, 2560),
                (512, 4, 2560))
#: tests/test_kernels.py's rtol and atol (the sum order differs)
RGLRU_TOL = (1e-4, 1e-4)
RGLRU_HEAD = RGLRU_SHAPES[-1]
#: serve_a: full width, one (rglru, rglru, local) unit, f32 weights
#: seeded on the card and copied to the CPU; 2 requests x 256 tokens, 8
#: new; card logits (kernels) against the port's CPU logits (plain
#: versions), teacher-forced on the CPU's tokens
SERVE_A = dict(layers=3, requests=2, prompt=256, new=8, seed=13)
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

KERNELS = ("engine_step", "colibri_scatter", "flash_attention", "rglru_scan")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def full_width_spec(proto: str, n: int, bins: int) -> Spec:
    return Spec(protocol=proto, workload="zipf_histogram", zipf_skew=0,
                n_cores=n, n_addrs=bins)


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
    return full_width_spec(proto, n, bins).replace(record_trace=True,
                                                   telemetry_windows=64)


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

def random_bank(proto, p, a, n, q_cap, rng) -> dict:
    """Seeded random bank state of the protocol's layout (numpy)."""
    bank = convert.to_numpy(proto.init_bank_state(p, a, n, q_cap, "cpu"))
    if "resv_core" in bank:
        bank["resv_core"] = rng.integers(-1, n, a).astype(np.int32)
        bank["resv_valid"] = rng.random(a) < 0.5
    if "qbuf" in bank:
        bank["qbuf"] = rng.integers(-1, n, (a, q_cap)).astype(np.int32)
        bank["qhead"] = rng.integers(0, q_cap, a).astype(np.int32)
        bank["qlen"] = rng.integers(0, q_cap + 1, a).astype(np.int32)
        bank["wake_tmr"] = rng.integers(0, 8, a).astype(np.int32)
    return bank


def random_step(n, a, cyc, rng) -> dict:
    """Seeded random per-core inputs of one engine step (numpy)."""
    shift = int(rng.integers(0, n))
    cand = rng.integers(0, cyc + 1, n).astype(np.int32)
    cand[rng.random(n) < 0.5] = sim._BIG
    return dict(cand_cyc=cand,
                rot=((np.arange(n) + shift) % n).astype(np.int32),
                addr=rng.integers(0, a, n).astype(np.int32),
                phase=rng.integers(0, 2, n).astype(np.int32),
                acq_start=rng.integers(0, cyc + 1, n).astype(np.int32),
                shift=shift)


def step_kwargs(inputs, dev, cyc, p, n, a, q_cap, cycles) -> dict:
    kw = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()
          if k != "shift"}
    kw.update(core={}, cyc=cyc, shift=inputs["shift"], lat=p.lat, n=n, a=a,
              q_cap=q_cap, cycles=cycles)
    return kw


def compare(out_k, out_r) -> int:
    """Max |kernel - plain| over every output and bank array; raises on
    a dtype or shape mismatch."""
    worst = 0
    keys = ("valid", "win", "kind", "tmr", "polls", "msgs", "hist",
            "lat_max")
    pairs = [(k, out_k[k], out_r[k]) for k in keys]
    pairs += [(f"bank.{k}", out_k["bank"][k], out_r["bank"][k])
              for k in out_r["bank"]]
    for name, x, y in pairs:
        require(x.dtype == y.dtype and x.shape == y.shape,
                f"{name}: {x.dtype}{tuple(x.shape)} vs "
                f"{y.dtype}{tuple(y.shape)}")
        d = (x.cpu().to(torch.int64) - y.cpu().to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


def phase_kernel(dev) -> int:
    worst, cases = 0, 0
    for i, name in enumerate(PROTOS):
        proto = protocols.get(name)
        for j, (n, a) in enumerate(KERNEL_SHAPES):
            rng = np.random.default_rng([11, i, j])
            p = sim.SimParams(protocol=name, n_cores=n, n_addrs=a)
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
                require(err == 0, f"{name} n={n} a={a}: kernel differs "
                                  f"from plain by {err}")
                worst = max(worst, err)
                bank_k, bank_r = out_k["bank"], out_r["bank"]
                cyc += 1
                cases += 1
    emit(phase="kernel", cases=cases, shapes=KERNEL_SHAPES,
         protocols=PROTOS, max_abs_err=worst, equal=True)
    return worst


def scatter_inputs(dev, t: int, bins: int, d: int, dtype: str, seed: int):
    """Seeded keys in [0, bins) and standard-normal values on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, bins, (t,), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((t, d), generator=g, device=dev)
    return keys, vals.to(getattr(torch, dtype))


def phase_scatter_kernel(dev) -> dict:
    worst = dict.fromkeys(SCATTER_TOL, 0.0)
    for i, (t, bins, d, dtype) in enumerate(SCATTER_SHAPES):
        keys, vals = scatter_inputs(dev, t, bins, d, dtype, i)
        dropped = keys.clone()
        dropped[::7] = bins                      # out of range: dropped
        for k in (keys, dropped):
            out = colibri_scatter.colibri_scatter_add(k, vals, bins)
            ref = colibri_scatter.scatter_add_ref(k, vals, bins)
            hist = colibri_scatter.colibri_histogram(k, bins)
            torch.cuda.synchronize()
            what = f"T={t} bins={bins} d={d} {dtype}"
            require(out.dtype == vals.dtype
                    and tuple(out.shape) == (bins, d), f"{what}: output "
                    f"{out.dtype}{tuple(out.shape)}")
            rtol, atol = SCATTER_TOL[dtype]
            err = float((out.float() - ref.float()).abs().max())
            require(torch.allclose(out.float(), ref.float(), rtol=rtol,
                                   atol=atol),
                    f"{what}: kernel differs from plain by {err}")
            worst[dtype] = max(worst[dtype], err)
            require(torch.equal(hist, colibri_scatter.histogram_ref(k, bins))
                    and torch.equal(hist, torch.bincount(
                        k[k < bins], minlength=bins).int()),
                    f"{what}: histogram differs")
            if d == 1:
                flat = colibri_scatter.colibri_scatter_add(k, vals[:, 0],
                                                           bins)
                require(torch.equal(flat, out[:, 0]),
                        f"{what}: 1-D vals differ")
    emit(phase="scatter_kernel", cases=2 * len(SCATTER_SHAPES),
         shapes=SCATTER_SHAPES, max_abs_err=worst, tolerance=SCATTER_TOL,
         histograms_exact=True, equal=True)
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
    emit(phase="exact", zipf_bins=bins, zipf_inputs=1 << 24,
         hash_inputs=int(x.size), equal=True)


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


def phase_golden() -> None:
    n_points = 0
    for name in PROTOS:
        for i, cfg in enumerate(GOLDEN_CONFIGS):
            reset_launches()
            r = run(Spec(protocol=name, **cfg))
            require(LAUNCHES["engine_step"] == cfg["cycles"],
                    f"{name}/{i}: {LAUNCHES['engine_step']} launches")
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
        r = run(Spec(protocol=proto, **cfg))
        got = observe(r.stats)
        require({k: got[k] for k in want} == want, f"{key}: {got} != {want}")
        n_points += 1
    emit(phase="golden", points=n_points, cpu_points=len(PROTOS),
         equal=True)


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


def device_rows(prof) -> list:
    """(name, count, device µs) of every device activity (kernels,
    memsets, copies) a ``torch.profiler`` run recorded."""
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0)
        if dt and ev.key and not ev.key.startswith(("aten::", "cuda")):
            rows.append((ev.key, ev.count, dt))
    rows.sort(key=lambda r: -r[2])
    return rows


def device_ms(fn, reps: int):
    """Device time per call of ``fn``: the sum of the device activities
    it launches, from ``torch.profiler``, over ``reps`` calls.  A
    profile that recorded no device activity is taken again, up to three
    times, and then reported as ``None`` (not measured)."""
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
        busy = sum(r[2] for r in device_rows(prof))
        if busy > 0:
            return busy / reps / 1e3
    return None


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


def phase_main() -> dict:
    points, by, total = [], {}, 0
    for name, n, bins in FULL_WIDTH_POINTS:
        spec = full_width_spec(name, n, bins)
        reset_launches()
        t0 = time.perf_counter()
        r = run(spec)
        wall = time.perf_counter() - t0
        launches = LAUNCHES["engine_step"]
        total += launches
        cycles = spec.costs.cycles
        got = full_width_summary(r.stats)
        want = FULL_WIDTH_REF[f"{name}/{n}/{bins}"]
        require(got == want, f"{name}/{n}/{bins}: {got} != {want}")
        require(launches == cycles,
                f"{name}/{n}/{bins}: {launches} launches, {cycles} cycles")
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
         colibri_over_lrsc_1bin=ratio, equal=True)
    return dict(launches=total, points=points)


def phase_trace(main_points: list) -> dict:
    """The trace path at full width, each point beside its untraced run
    of the main phase (same call, same card)."""
    untraced = {(r["protocol"], r["cores"], r["bins"]): r["wall_s"]
                for r in main_points}
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    total = dict.fromkeys(LAUNCHES, 0)
    by = {}
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
        require(launches["engine_step"] == cycles,
                f"{key}: {launches['engine_step']} engine_step launches, "
                f"{cycles} cycles")
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
        base = untraced[(name, n, bins)]
        emit(phase="trace_point", equal=True, protocol=name, cores=n,
             bins=bins, cycles=cycles, launches=launches, wall_s=wall,
             ms_per_cycle=wall / cycles * 1e3, untraced_wall_s=base,
             untraced_ms_per_cycle=base / cycles * 1e3,
             overhead_ms_per_cycle=(wall - base) / cycles * 1e3,
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
    return dict(launches=total)


def profile_run(spec) -> dict:
    """Device activity of one run of ``spec`` under ``torch.profiler``,
    after a warm run and an unprofiled timed run."""
    from torch.profiler import ProfilerActivity, profile
    cycles = spec.costs.cycles
    launches = dict(LAUNCHES)
    run(spec)                                          # warm
    t0 = time.perf_counter()
    run(spec)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(spec)
        wall_prof = time.perf_counter() - t0
    LAUNCHES.update(launches)                  # not a path's counted run
    rows = device_rows(prof)
    busy = sum(r[2] for r in rows)
    kern = [r for r in rows if "engine_step" in r[0]]
    return dict(cycles=cycles, wall_s=wall, wall_s_profiled=wall_prof,
                ms_per_cycle=wall / cycles * 1e3, device_busy_us=busy,
                device_busy_share=busy / 1e6 / wall,
                device_activities_per_cycle=sum(r[1] for r in rows) / cycles,
                engine_step_us=sum(r[2] for r in kern),
                engine_step_launches=sum(r[1] for r in kern),
                engine_step_share_of_busy=sum(r[2] for r in kern) / busy,
                top=[dict(kernel=k[:80], count=c, us=t)
                     for k, c, t in rows[:12]])


def phase_profile() -> None:
    """Device time by kernel over 300 cycles of the 256-core colibri
    point, untraced and with the trace and telemetry on: how busy the
    card is, and the engine_step kernel's share of it."""
    spec = Spec(protocol="colibri", workload="zipf_histogram", zipf_skew=0,
                n_cores=256, n_addrs=1, cycles=300)
    emit(phase="profile", **profile_run(spec))
    emit(phase="profile_traced", **profile_run(
        spec.replace(record_trace=True, telemetry_windows=64)))


def time_scatter(dev, t: int, bins: int, d: int, dtype: str) -> dict:
    """Device time per call of the commit kernel (on pre-sorted
    inputs), the whole op (sort + commit), the plain version and
    ``index_add_`` (and, for histograms, ``colibri_histogram`` and
    ``torch.bincount``), beside the commit's bound."""
    keys, vals = scatter_inputs(dev, t, bins, d, dtype, seed=t + bins + d)
    order = torch.argsort(keys, stable=True)
    sk, sv = keys[order].contiguous(), vals[order].contiguous()
    buf = torch.zeros((bins, d), dtype=vals.dtype, device=dev)
    reps = 20 if t * d >= 1 << 20 else 100
    n_bytes = 4 * t + (t + bins) * d * vals.element_size()
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
        bound_bytes=n_bytes, bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3)
    if d == 1 and dtype == "float32":
        lk = keys.long()
        rec["histogram_op_ms"] = device_ms(
            lambda: colibri_scatter.colibri_histogram(keys, bins), reps)
        rec["bincount_ms"] = device_ms(
            lambda: torch.bincount(lk, minlength=bins), reps)
    LAUNCHES["colibri_scatter"] = launches     # timing runs are not counted
    return rec


# ---- the LM serve path ---------------------------------------------------

def flash_inputs(dev, b, sq, skv, h, kv, hd, dtype, seed):
    """Seeded standard-normal q ``(b, sq, h, hd)`` and k, v ``(b, skv,
    kv, hd)`` on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dt)
                 for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                               (b, skv, kv, hd)))


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
        worst[dtype] = max(worst[dtype], err)
    emit(phase="flash_kernel", cases=len(FLASH_SHAPES), shapes=FLASH_SHAPES,
         max_abs_err=worst, tolerance=FLASH_TOL, equal=True)
    return worst


def rglru_inputs(dev, t, b, w, seed):
    """Seeded decays in (0, 1), inputs and initial state on the card, as
    the reference tests draw them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.sigmoid(torch.randn((t, b, w), generator=g, device=dev) + 2.0)
    x = torch.randn((t, b, w), generator=g, device=dev) * 0.3
    return a, x, torch.randn((b, w), generator=g, device=dev)


def phase_rglru_kernel(dev) -> float:
    worst = 0.0
    rtol, atol = RGLRU_TOL
    for i, (t, b, w) in enumerate(RGLRU_SHAPES):
        a, x, h0 = rglru_inputs(dev, t, b, w, i)
        out = rglru_scan.rglru_scan(a, x, h0)
        ref = rglru_scan.rglru_scan_ref(a, x, h0)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        require(out.dtype == torch.float32 and tuple(out.shape) == (t, b, w)
                and torch.allclose(out, ref, rtol=rtol, atol=atol),
                f"{(t, b, w)}: kernel differs from plain by {err}")
        worst = max(worst, err)
    emit(phase="rglru_kernel", cases=len(RGLRU_SHAPES), shapes=RGLRU_SHAPES,
         max_abs_err=worst, tolerance=RGLRU_TOL, equal=True)
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
                  forced=None):
    """The engine's steps for equal-length prompts, keeping the logits:
    prefill, then ``new`` decode steps, each fed the argmax of the last
    logits, or ``forced[:, step]``.  Returns (logits of each step on the
    CPU, (B, new) tokens fed)."""
    dev = model.device
    hidden, cache = model.prefill(torch.from_numpy(toks).to(dev), cache_len)
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


def phase_serve_a(dev) -> dict:
    """Full width, one (rglru, rglru, local) unit, f32: the card's
    prefill and decode logits against the port's on the CPU, on the
    same weights, teacher-forced on the CPU's greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sa = SERVE_A
    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              num_layers=sa["layers"],
                              param_dtype="float32", compute_dtype="float32")
    cache_len = sa["prompt"] + sa["new"]
    toks = prompts(cfg.vocab_size, sa["requests"], sa["prompt"], sa["seed"])
    card = build(cfg, dev).init(sa["seed"])
    cpu = build(cfg, "cpu").load_params(card.params())
    t0 = time.perf_counter()
    cpu_tokens = serve(ServeEngine(cfg, cpu, batch_size=sa["requests"],
                                   cache_len=cache_len, device="cpu"),
                       toks, sa["new"])
    cpu_logits, fed = greedy_logits(cpu, toks, sa["new"], cache_len)
    cpu_s = time.perf_counter() - t0
    require(np.array_equal(fed, cpu_tokens),
            f"CPU engine tokens {cpu_tokens} != its greedy steps {fed}")
    del cpu
    reset_launches()
    card_logits, _ = greedy_logits(card, toks, sa["new"], cache_len,
                                   forced=cpu_tokens)
    launches = dict(LAUNCHES)
    card_tokens = serve(ServeEngine(cfg, card, batch_size=sa["requests"],
                                    cache_len=cache_len), toks, sa["new"])
    rtol, atol = SERVE_A_TOL
    errs = []
    for step, (c, g) in enumerate(zip(cpu_logits, card_logits)):
        require(bool(torch.isfinite(g).all()), f"step {step}: logits not "
                                                f"finite")
        errs.append(float((g - c).abs().max()))
        require(torch.allclose(g, c, rtol=rtol, atol=atol),
                f"step {step}: card logits differ from the CPU's by "
                f"{errs[-1]}")
    require(launches["flash_attention"] == 1 and launches["rglru_scan"] == 2,
            f"one unit's prefill launched {launches}")
    emit(phase="serve_a", arch=SERVE_ARCH, layers=sa["layers"],
         requests=sa["requests"], prompt=sa["prompt"], new=sa["new"],
         dtype="float32", max_abs_err_by_step=errs, max_abs_err=max(errs),
         tolerance=SERVE_A_TOL, launches=launches,
         cpu_tokens=cpu_tokens.tolist(), card_tokens=card_tokens.tolist(),
         tokens_agree=bool(np.array_equal(cpu_tokens, card_tokens)),
         cpu_seconds=cpu_s, equal=True)
    return dict(max_abs_err=max(errs))


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


def phase_serve_b(dev) -> dict:
    """The main path of the LM: recurrentgemma-2b at full width and depth
    (bf16, seeded on the card) serving one batch through ServeEngine."""
    sb = SERVE_B
    cfg = get_config(SERVE_ARCH)
    cache_len = sb["prompt"] + sb["new"]
    toks = prompts(cfg.vocab_size, sb["requests"], sb["prompt"], sb["seed"])
    t0 = time.perf_counter()
    model = build(cfg, dev).init(sb["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
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

    def pre_call():
        state["out"] = model.prefill(x, cache_len)

    def dec_call():
        hidden, cache = state["out"]
        tok = model.logits(hidden[:, -1:])[:, -1].argmax(-1).int()[:, None]
        pos = torch.full((sb["requests"],), sb["prompt"], dtype=torch.int32,
                         device=dev)
        model.decode_step(cache, tok, pos)
    profiles = dict(prefill=profile_call(pre_call),
                    decode_step=profile_call(dec_call))
    LAUNCHES.update(launches_after)
    pre, dec = probe.calls["prefill"][0], probe.calls["decode_step"][:sb["new"]]
    require(all(c["finite"] for c in probe.calls["prefill"]
                + probe.calls["decode_step"] + probe.calls["logits"]),
            "non-finite hidden states or logits")
    require(tokens.shape == (sb["requests"], sb["new"]),
            f"tokens {tokens.shape}")
    for k, n in SERVE_B_LAUNCHES.items():
        require(pre["launches"][k] == n and launches[k] == n,
                f"{k}: {pre['launches'][k]} launches in the prefill, "
                f"{launches[k]} in the batch, want {n}")
        require(all(c["launches"][k] == 0 for c in dec),
                f"{k} launched in decode")
    decode_s = sum(c["seconds"] for c in dec)
    emit(phase="serve_b", arch=SERVE_ARCH, layers=cfg.num_layers,
         params=n_params, dtype=cfg.param_dtype, requests=sb["requests"],
         prompt=sb["prompt"], new=sb["new"], init_s=init_s,
         launches=launches, prefill_launches=pre["launches"],
         decode_launches=sum(sum(c["launches"].values()) for c in dec),
         prefill_ms=pre["seconds"] * 1e3,
         decode_ms_per_token=decode_s / len(dec) * 1e3,
         batch_wall_s=wall,
         tokens_per_s=sb["requests"] * sb["new"] / wall,
         peak_memory_bytes=peak, tokens=tokens.tolist(),
         solo_tokens=solo[0].tolist(),
         solo_agrees=bool(np.array_equal(solo[0], tokens[0])),
         logits_finite=True, profile=profiles)
    return dict(launches=launches)


def flash_bound(b, sq, skv, h, kv, hd, causal, dtype) -> dict:
    """The least time the card could take for one flash call: q, k, v
    read once (KV heads not repeated), o written once, over 3.35 TB/s;
    the products of the unmasked (query, key) pairs, 4 * hd flops each,
    over the type's peak."""
    size = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    n_bytes = (2 * b * sq * h * hd + 2 * b * skv * kv * hd) * size
    pairs = (sum(min(i + 1, skv) for i in range(sq)) if causal
             else sq * skv)
    flops = 4 * hd * pairs * b * h
    peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return dict(bound_bytes=n_bytes, bound_flops=flops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_flash(dev) -> dict:
    b, sq, skv, h, kv, hd, causal, dtype = FLASH_HEAD
    q, k, v = flash_inputs(dev, b, sq, skv, h, kv, hd, dtype, seed=5)
    # the library call's layout: heads first, KV heads repeated
    qs, ks, vs = (t.repeat_interleave(h // t.shape[2], dim=2)
                  .transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    launches = LAUNCHES["flash_attention"]
    rec = dict(shape=FLASH_HEAD,
               ms=device_ms(lambda: fa_kernel.flash_attention_cuda(
                   q, k, v, causal=causal), 20),
               plain_ms=device_ms(lambda: flash_attention.flash_attention_ref(
                   q, k, v, causal=causal), 10),
               library_ms=device_ms(lambda: sdpa(qs, ks, vs,
                                                 is_causal=causal), 20),
               **flash_bound(*FLASH_HEAD))
    LAUNCHES["flash_attention"] = launches     # timing runs are not counted
    return rec


def time_rglru(dev) -> dict:
    t, b, w = RGLRU_HEAD
    a, x, h0 = rglru_inputs(dev, t, b, w, seed=5)
    n_bytes = 12 * t * b * w + 4 * b * w
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2 * t * b * w / F32_FLOPS
    launches = LAUNCHES["rglru_scan"]
    rec = dict(shape=RGLRU_HEAD,
               ms=device_ms(lambda: rg_kernel.rglru_scan_cuda(a, x, h0), 50),
               plain_ms=device_ms(lambda: rglru_scan.rglru_scan_ref(a, x, h0),
                                  3),
               library_ms=None, bound_bytes=n_bytes,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    LAUNCHES["rglru_scan"] = launches          # timing runs are not counted
    return rec


def lm_phases(dev) -> list:
    """The serve path's phases; its entries of the kernels line."""
    flash_worst = timed(phase_flash_kernel, dev)
    rglru_worst = timed(phase_rglru_kernel, dev)
    timed(phase_serve_a, dev)
    main_run = timed(phase_serve_b, dev)
    t0 = time.perf_counter()
    flash_t, rglru_t = time_flash(dev), time_rglru(dev)
    emit(phase="lm_kernel_time", seconds=time.perf_counter() - t0,
         flash_attention=flash_t, rglru_scan=rglru_t)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:22",
             launches=main_run["launches"]["flash_attention"],
             max_abs_err=max(flash_worst.values()),
             **{k: flash_t[k] for k in keys},
             max_abs_err_by_dtype=flash_worst, shape=flash_t["shape"]),
        dict(name="rglru_scan", route="cuda",
             source="src/repro_torch/csrc/rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan/kernel.py:20",
             launches=main_run["launches"]["rglru_scan"],
             max_abs_err=rglru_worst, **{k: rglru_t[k] for k in keys},
             shape=rglru_t["shape"])]


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
    for mod in (es_kernel, cs_kernel, fa_kernel, rg_kernel):
        mod._launcher()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries={k: Path(v["path"]).name for k, v in builds.items()},
         ptxas={k: [ln.strip() for ln in v["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in builds.items()})
    return dev


def main() -> int:
    t_start = time.perf_counter()
    dev = setup()
    if dev is None:
        return 1
    smi = CARD["card"]

    worst = timed(phase_kernel, dev)
    scatter_worst = timed(phase_scatter_kernel, dev)
    lm_kernels = lm_phases(dev)
    timed(phase_exact, dev)
    timed(phase_golden)
    main_run = timed(phase_main)
    trace_run = timed(phase_trace, main_run["points"])
    timed(phase_profile)

    timing = [time_kernel(dev, "colibri", 256, 1),
              time_kernel(dev, "lrsc", 256, 256),
              time_kernel(dev, "colibri", 1024, 1)]
    head = timing[0]
    emit(phase="kernel_time", shapes=timing)
    kernels = [dict(
        name="engine_step", route="cuda",
        source="src/repro_torch/csrc/engine_step.cu",
        replaces="src/repro/kernels/engine_step/kernel.py:45",
        launches=main_run["launches"], max_abs_err=worst,
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=None, call_ms=head["call_ms"],
        plain_call_ms=head["plain_call_ms"],
        shape=dict(protocol=head["protocol"], n=head["n"], a=head["a"]))]
    t0 = time.perf_counter()
    scatter_times = [time_scatter(dev, *shape) for shape in SCATTER_SHAPES]
    emit(phase="scatter_time", seconds=time.perf_counter() - t0,
         shapes=scatter_times)
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
        op_ms=head["op_ms"], max_abs_err_by_dtype=scatter_worst,
        shape=dict(t=head["t"], bins=head["bins"], d=head["d"],
                   dtype=head["dtype"])))
    kernels += lm_kernels
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
