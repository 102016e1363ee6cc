#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the whole check, one NVIDIA GPU

Phases, one JSON line each:

1. device — needs ``torch.cuda.is_available()``; prints ``nvidia-smi``'s
   name and power limit of the card;
2. build — compiles the ``engine_step`` CUDA kernel from the checkout;
3. kernel — the kernel against its plain PyTorch version on the card,
   for each protocol at every (cores, banks) shape the later phases give
   it, plus the reference's multi-tile case, over chained cycles from
   seeded random states: every output and bank array must be equal;
4. exact — ``zipf_index`` (skew 0) and ``_hash`` on the card against the
   CPU over 2^24 inputs;
5. golden — ``repro_torch.sync.run`` on the card reproduces the
   reference's golden values (``tests/test_protocols.py``), and one point
   per protocol equals the port's own CPU run key for key;
6. main path — the paper's 256-core MemPool at 20 000 cycles (Fig. 3
   histogram, uniform bins) for colibri and lrsc at 1 and 256 bins, and
   a 1024-core colibri point: summaries and metrics equal the
   reference's values below, and the kernel ran once per cycle;
7. profile — device time by kernel over 300 cycles of the main path
   (``torch.profiler``): kernels per cycle, device busy share;
8. kernels — the kernel's launches, agreement and times: device time
   per call (profiler) beside the bound and the plain version's, and the
   host-paced time per call (CUDA events over back-to-back calls).

The reference values below were computed with the JAX package
(``repro``); ``tests/test_torch_sync.py`` recomputes them so they cannot
drift.  The script imports neither JAX nor ``repro``.  It exits non-zero
when any phase fails, and its last line is the device record.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import protocols, sim  # noqa: E402
from repro_torch.core.workloads.base import zipf_index  # noqa: E402
from repro_torch.kernels import LAUNCHES, engine_step  # noqa: E402
from repro_torch.kernels.engine_step import kernel as es_kernel  # noqa: E402
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


class Failed(Exception):
    """A phase's check failed."""


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


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


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: the sum of the device activities
    it launches, from ``torch.profiler``, over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(r[2] for r in device_rows(prof)) / reps / 1e3


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


def phase_profile() -> None:
    """Device time by kernel over 300 cycles of the 256-core colibri
    point: how busy the card is, and the kernel's share of it."""
    from torch.profiler import ProfilerActivity, profile
    cycles = 300
    spec = Spec(protocol="colibri", workload="zipf_histogram", zipf_skew=0,
                n_cores=256, n_addrs=1, cycles=cycles)
    launches = LAUNCHES["engine_step"]
    run(spec)                                          # warm
    t0 = time.perf_counter()
    run(spec)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(spec)
        wall_prof = time.perf_counter() - t0
    LAUNCHES["engine_step"] = launches         # not the main path's run
    rows = device_rows(prof)
    busy = sum(r[2] for r in rows)
    kern = [r for r in rows if "engine_step" in r[0]]
    emit(phase="profile", cycles=cycles, wall_s=wall,
         wall_s_profiled=wall_prof, device_busy_us=busy,
         device_busy_share=busy / 1e6 / wall,
         device_activities_per_cycle=sum(r[1] for r in rows) / cycles,
         engine_step_us=sum(r[2] for r in kern),
         engine_step_launches=sum(r[1] for r in kern),
         engine_step_share_of_busy=sum(r[2] for r in kern) / busy,
         top=[dict(kernel=k[:80], count=c, us=t) for k, c, t in rows[:12]])


def timed(phase, *args):
    """Run one phase and report its wall seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit(phase=f"{phase.__name__}_seconds", seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = smi_line()
    print(smi, flush=True)
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    info = es_kernel.build()
    es_kernel._launcher()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0,
         library=Path(info["path"]).name, ptxas=ptxas)

    worst = timed(phase_kernel, dev)
    timed(phase_exact, dev)
    timed(phase_golden)
    main_run = timed(phase_main)
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
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
