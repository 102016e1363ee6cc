"""The port on an NVIDIA GPU: the CUDA kernels and runs through them (the
simulator's engine, one engine_run launch per run held against the
per-cycle loop, the workload programs on its program instance, a Study
as one launch per core count held against its single runs, and
recurrentgemma-2b-smoke, rwkv6-1.6b-smoke and kimi-k2-1t-a32b-smoke
served by ServeEngine, the flash kernel's window and MLA's 192/128 head
dims, whisper's non-causal encoder and cross-attention shapes and head
dim 96, whisper-large-v3-smoke's and phi-3-vision-4.2b-smoke's prefill,
chip_smoke's mla_serve_a, long_serve_a, whisper_serve_a and phi_serve_a
at full width, the model checker with the step kernel as its
fused twin, and the flash-attention backward kernels with
smollm-135m-smoke's training through them).

Every test here is marked ``gpu`` and skips without a CUDA device (the
CUDA kernel has no CPU mode).  The file imports neither JAX nor the
reference package, so it runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The expected values come from ``chip_smoke.py``, whose embedded
reference values ``tests/test_torch_sync.py`` and
``tests/test_torch_trace_values.py`` recompute with JAX.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import protocols, sim
from repro_torch.core.sim import SimParams
from repro_torch.configs import get_config
from repro_torch.kernels import (LAUNCHES, colibri_scatter, engine_step,
                                 flash_attention, grouped_matmul, rglru_scan,
                                 rwkv6_wkv)
from repro_torch.models import build
from repro_torch.serving import ServeEngine
from repro_torch.sync import Spec, run

PROTOS = ("amo", "lrsc", "lrscwait", "colibri", "amo_lock", "lrsc_lock",
          "ticket_lock", "mwait_lock", "colibri_hier", "hw_event", "nb_feb")
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", PROTOS)
def test_cuda_kernel_matches_plain_version(name, cuda_device):
    cs = _chip_smoke()
    rng = np.random.default_rng(PROTOS.index(name))
    proto = protocols.get(name)
    n, a = 256, 64
    p = SimParams(protocol=name, n_cores=n, n_addrs=a)
    q_cap = proto.q_cap(p, n)
    bank0 = cs.random_bank(proto, p, a, n, q_cap, rng)
    bank_k = convert.to_torch(bank0, cuda_device)
    bank_r = convert.to_torch(bank0, cuda_device)
    for cyc in range(3000, 3004):
        kw = cs.step_kwargs(cs.random_step(n, a, cyc, rng), cuda_device, cyc,
                            p, n, a, q_cap, cyc + 12)
        before = LAUNCHES["engine_step"]
        out_k = engine_step.fused_step(proto, p, bank_k, **kw)
        out_r = engine_step.fused_step_ref(proto, p, bank_r, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES["engine_step"] == before + 1
        assert cs.compare(out_k, out_r) == 0, (name, cyc)
        bank_k, bank_r = out_k["bank"], out_r["bank"]


@pytest.mark.gpu
def test_run_on_gpu_matches_golden_and_cpu(cuda_device):
    cs = _chip_smoke()
    cfg = cs.GOLDEN_CONFIGS[1]
    before = dict(LAUNCHES)
    gpu = run(Spec(protocol="colibri", **cfg))
    assert LAUNCHES["engine_run"] == before["engine_run"] + 1
    assert LAUNCHES["engine_step"] == before["engine_step"]
    cpu = run(Spec(protocol="colibri", **cfg), device="cpu")
    want = cs.GOLDEN["colibri/1"]
    obs = cs.observe(gpu.stats)
    assert {k: obs[k] for k in want} == want
    assert cs.int_keys_equal(gpu.stats, cpu.stats) == []


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", PROTOS)
def test_run_kernel_matches_the_plain_loop(name, traced, cuda_device):
    """One engine_run launch equals the plain loop (one engine_step
    launch a cycle) on every key, traces and telemetry included, in the
    kernel's register and shared-memory layouts and in its two others
    (chip_smoke.LAYOUT_CASES)."""
    cs = _chip_smoke()
    points = [(256, 64, 200), (2048, 512, 200)] + [
        (n, a, cs.LAYOUT_CASE_CYCLES) for n, a in cs.LAYOUT_CASES]
    for n, a, cycles in points:
        p = SimParams(protocol=name, workload="zipf_histogram", zipf_skew=0,
                      n_cores=n, n_addrs=a, cycles=cycles, seed=-(2**33) - 3,
                      record_trace=traced, telemetry_windows=16 * traced)
        before = dict(LAUNCHES)
        assert cs.run_case(p, cuda_device)[:2] == (p.cycles, 0.0)
        assert LAUNCHES["engine_run"] == 1
        LAUNCHES.update(before)


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("wl", ["ms_queue", "treiber_stack",
                                "barrier_phases"])
def test_program_run_kernel_matches_the_plain_loop(wl, traced, cuda_device):
    """The workload programs on the run kernel's program instance: one
    engine_run launch equals the plain loop on every key for every
    protocol at the workload's scenario, in the register layout and with
    the per-core state in device memory (more than 2 048 cores)."""
    cs = _chip_smoke()
    for i, name in enumerate(PROTOS):
        for n, cycles in ((256, 200), (2100, cs.LAYOUT_CASE_CYCLES)):
            p = SimParams(protocol=name, workload=wl, n_cores=n,
                          cycles=cycles, seed=17 * i - 5,
                          record_trace=traced, telemetry_windows=16 * traced,
                          **cs.workloads.get(wl).scenario)
            before = dict(LAUNCHES)
            assert cs.run_case(p, cuda_device)[:2] == (p.cycles, 0.0)
            LAUNCHES.update(before)


@pytest.mark.gpu
def test_own_program_and_barrier_workers_on_gpu(cuda_device):
    """chip_smoke's own program (per-step durations, a barrier
    mid-program) for every protocol, and barrier_phases beside Fig. 5
    workers, one launch each, equal to the plain loop on every key."""
    cs = _chip_smoke()
    params = [SimParams(protocol=name, workload="barrier_phases",
                        n_cores=128, n_addrs=1, n_workers=16, net_bw=13,
                        hol_block=16, cycles=300, seed=3, record_trace=True,
                        telemetry_windows=8) for name in PROTOS]
    with cs.own_program():
        params += [SimParams(protocol=name, workload=cs.OWN_PROGRAM,
                             n_cores=96, n_addrs=3, zipf_skew=0,
                             backoff=24, cycles=300, seed=i,
                             record_trace=True, telemetry_windows=8)
                   for i, name in enumerate(PROTOS)]
        for p in params:
            before = dict(LAUNCHES)
            assert cs.run_case(p, cuda_device)[:2] == (p.cycles, 0.0)
            LAUNCHES.update(before)


@pytest.mark.gpu
def test_program_study_on_gpu_equals_single_runs(cuda_device):
    """A Study of one-step and program points on the card: one launch per
    core count (the program instance runs the one-step points beside the
    programs), every point equal to its single run and to the CPU's."""
    from repro_torch.sync import Study
    cs = _chip_smoke()
    specs = [cs.program_spec(pr, wl, n, 800, seed=s)
             for pr, wl, n, s in (("colibri", "ms_queue", 64, 1),
                                  ("lrsc", "barrier_phases", 64, 2),
                                  ("nb_feb", "treiber_stack", 64, 3),
                                  ("amo", "rmw_loop", 64, 4),
                                  ("colibri_hier", "ms_queue", 32, 5),
                                  ("ticket_lock", "barrier_phases", 32, 6))]
    before = dict(LAUNCHES)
    got = Study.from_specs(specs).run()
    assert LAUNCHES["engine_run"] - before["engine_run"] == 2
    assert LAUNCHES["engine_step"] == before["engine_step"]
    cpu = Study.from_specs(specs).run(device="cpu")
    for spec, r, c in zip(specs, got, cpu):
        assert r.ok
        r.check()
        assert cs.swept_diff(r.stats, run(spec).stats,
                             spec.to_params()) == []
        assert cs.int_keys_equal(r.stats, c.stats) == []


@pytest.mark.gpu
@pytest.mark.parametrize("name", PROTOS)
def test_topology_and_zipf_run_kernel_match_the_plain_loop(name,
                                                           cuda_device):
    """The run kernel's topology instance (cluster2 and cluster3, link
    budgets that turn requests away, the skewed stream's threshold lookup
    in the sweep's form) and the Zipf cases: one engine_run launch equals
    the plain loop on every key, ``hops`` included."""
    cs = _chip_smoke()
    cases = [(p, tr) for p, tr in cs.topo_zipf_params()
             if p.protocol == name]
    assert cases
    for p, traced in cases:
        p = cs.dataclasses.replace(p, cycles=min(p.cycles, 150))
        before = dict(LAUNCHES)
        assert cs.run_case(p, cuda_device, traced)[:2] == (p.cycles, 0.0)
        LAUNCHES.update(before)


@pytest.mark.gpu
@pytest.mark.parametrize("name", PROTOS)
def test_fault_run_kernel_matches_the_plain_loop(name, cuda_device):
    """The run kernel's fault instance under chip_smoke's mixed plan (a
    holder kill, the watchdog, request and wakeup drops, a bank stall,
    the progress detector) and its other fault cases: one engine_run
    launch equals the plain loop on every key, the fault keys included."""
    cs = _chip_smoke()
    cases = [p for p in cs.fault_params() if p.protocol == name]
    assert cases
    for p in cases:
        p = cs.dataclasses.replace(p, cycles=min(p.cycles, 150))
        before = dict(LAUNCHES)
        assert cs.run_case(p, cuda_device)[:2] == (p.cycles, 0.0)
        LAUNCHES.update(before)


@pytest.mark.gpu
def test_fault_study_on_gpu_equals_single_runs(cuda_device):
    """A Study of faulted and fault-free points, n_addrs off the buckets
    with a bank stall, on the card: one launch (the fault instance),
    every point equal to the CPU's Study and, where the bank-stall draw
    does not depend on the bucket, to its own single run."""
    from repro_torch.faults import FaultPlan
    from repro_torch.sync import Study
    cs = _chip_smoke()
    plan = FaultPlan(n_kill=2, kill_cyc=50, watchdog_cyc=24,
                     msg_drop_bp=200, n_bank_stall=1, bank_stall_cyc=80,
                     bank_stall_dur=100, progress_cyc=300)
    specs = [Spec(protocol=pr, n_cores=64, n_addrs=na, cycles=600, seed=s,
                  faults=fp)
             for s, (pr, na, fp) in enumerate((
                 ("colibri", 4, plan), ("lrsc", 3, plan), ("amo", 5, None),
                 ("ticket_lock", 4, None), ("hw_event", 5, plan)))]
    before = dict(LAUNCHES)
    got = Study.from_specs(specs).run()
    assert LAUNCHES["engine_run"] - before["engine_run"] == 1
    cpu = Study.from_specs(specs).run(device="cpu")
    for spec, r, c in zip(specs, got, cpu):
        assert r.ok and ("dead_mask" in r.stats) == spec.faults.enabled
        assert cs.int_keys_equal(r.stats, c.stats) == []
        if spec.topology.n_addrs == 4 or not spec.faults.enabled:
            assert cs.swept_diff(r.stats, cs.single_run(spec).stats,
                                 spec.to_params()) == []


@pytest.mark.gpu
def test_zipf_lookup_on_gpu_matches_the_cpu(cuda_device):
    """The kernel's threshold search and the skew-0 fused multiply-add on
    every 24-bit hash, against the CPU's zipf_index."""
    from repro_torch.core.workloads.base import (ADDR_ZIPF, zipf_factors,
                                                 zipf_index, zipf_thresholds)
    cs = _chip_smoke()
    h = torch.arange(1 << 24, dtype=torch.int64)
    hu = h.to(torch.int32).to(cuda_device)
    for b, skew, traced in cs.ZIPF_PROBES[:3]:
        thr = torch.from_numpy(zipf_thresholds(b, skew, traced)).to(
            cuda_device)
        got = cs.probe(hu, 2, ADDR_ZIPF, b, 0.0, thr).cpu()
        assert torch.equal(got, zipf_index(h, b, skew, traced))
    for b in cs.ZIPF_FMA_BINS:
        got = cs.probe(hu, 2, ADDR_ZIPF, b, zipf_factors(b, 0)).cpu()
        assert torch.equal(got, zipf_index(h, b, 0))


@pytest.mark.gpu
def test_topology_study_on_gpu_equals_single_runs(cuda_device):
    """A Study of flat and hierarchical points and skewed streams on the
    card: one launch (the topology instance), every point equal to its
    own single run and to the CPU's Study, ``hops`` only where the
    topology has levels."""
    from repro_torch.sync import Study
    cs = _chip_smoke()
    specs = [Spec(protocol=pr, topology=tp, clusters=c, n_cores=64,
                  n_addrs=na, cycles=600, seed=s, net_bw=9,
                  workload="zipf_histogram", zipf_skew=sk)
             for s, (pr, tp, c, na, sk) in enumerate((
                 ("colibri", "flat", 4, 4, 0), ("lrsc", "cluster2", 4, 4, 150),
                 ("colibri_hier", "cluster3", 8, 3, 200),
                 ("nb_feb", "cluster2", 4, 1000, 150),
                 ("amo", "flat", 4, 64, 200)))]
    before = dict(LAUNCHES)
    got = Study.from_specs(specs).run()
    assert LAUNCHES["engine_run"] - before["engine_run"] == 1
    cpu = Study.from_specs(specs).run(device="cpu")
    for spec, r, c in zip(specs, got, cpu):
        assert r.ok
        assert ("hops" in r.stats) == (spec.topology.name != "flat")
        assert cs.swept_diff(r.stats, cs.single_run(spec).stats,
                             spec.to_params()) == []
        assert cs.int_keys_equal(r.stats, c.stats) == []


@pytest.mark.gpu
@pytest.mark.parametrize("max_batch", [None, 2])
def test_study_on_gpu_equals_single_runs(max_batch, cuda_device):
    """A small Study on the card: one engine_run launch per launch group
    (core count) and chunk, every point equal to its single run (bank
    arrays padded to the bucket), and equal to the CPU's sweep."""
    from repro_torch.sync import Study
    cs = _chip_smoke()
    specs = [Spec(protocol=pr, workload="zipf_histogram", zipf_skew=0,
                  n_cores=n, n_addrs=a, cycles=600, seed=s, q_slots=q)
             for pr, n, a, s, q in (("colibri", 64, 3, 1, 256),
                                    ("lrsc", 64, 16, -5, 256),
                                    ("lrscwait", 64, 5, 2, 8),
                                    ("amo", 32, 7, 3, 256),
                                    ("lrscwait", 32, 1, 4, 256))]
    specs.append(specs[0].replace(record_trace=True, telemetry_windows=8,
                                  n_addrs=6))
    before = dict(LAUNCHES)
    got = Study.from_specs(specs).run(max_batch=max_batch)
    # 64 cores: 4 points, 32 cores: 2 points; at max_batch=2: 2 + 1
    want_launches = 2 if max_batch is None else 3
    assert LAUNCHES["engine_run"] - before["engine_run"] == want_launches
    assert LAUNCHES["engine_step"] == before["engine_step"]
    cpu = Study.from_specs(specs).run(device="cpu")
    for spec, r, c in zip(specs, got, cpu):
        assert r.ok
        assert cs.swept_diff(r.stats, run(spec).stats,
                             spec.to_params()) == []
        assert cs.int_keys_equal(r.stats, c.stats) == []


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 3, 16])
def test_colibri_hier_group_counts_on_gpu(groups, cuda_device):
    """colibri_hier's engine_run launch equals the plain loop at group
    counts that divide the cores (1, 16) and one that does not (3), and
    its per-cycle kernel equals its plain version from seeded random
    states of the shape the protocol reaches."""
    cs = _chip_smoke()
    p = SimParams(protocol="colibri_hier", n_groups=groups,
                  workload="zipf_histogram", zipf_skew=0, n_cores=256,
                  n_addrs=16, cycles=300, seed=7 + groups,
                  record_trace=True, telemetry_windows=8)
    before = dict(LAUNCHES)
    assert cs.run_case(p, cuda_device)[:2] == (p.cycles, 0.0)
    LAUNCHES.update(before)
    proto = protocols.get("colibri_hier")
    rng = np.random.default_rng(groups)
    bank0 = cs.random_bank(proto, p, 16, 256, proto.q_cap(p, 256), rng)
    bank_k = convert.to_torch(bank0, cuda_device)
    bank_r = convert.to_torch(bank0, cuda_device)
    for cyc in range(3000, 3004):
        kw = cs.step_kwargs(cs.random_step(256, 16, cyc, rng), cuda_device,
                            cyc, p, 256, 16, 256, cyc + 12)
        out_k = engine_step.fused_step(proto, p, bank_k, **kw)
        out_r = engine_step.fused_step_ref(proto, p, bank_r, **kw)
        torch.cuda.synchronize()
        assert cs.compare(out_k, out_r) == 0, cyc
        bank_k, bank_r = out_k["bank"], out_r["bank"]


@pytest.mark.gpu
def test_hier_group_counts_share_one_launch(cuda_device):
    """colibri_hier at three group counts beside hw_event, nb_feb and
    colibri: one engine_run launch, every point equal to its single run
    and to the CPU's, no poll."""
    from repro_torch.sync import Study
    cs = _chip_smoke()
    specs = [Spec(protocol=pr, n_groups=g, workload="zipf_histogram",
                  zipf_skew=0, n_cores=128, n_addrs=a, cycles=800, seed=s)
             for pr, g, a, s in (("colibri_hier", 1, 1, 1),
                                 ("colibri_hier", 3, 5, 2),
                                 ("colibri_hier", 16, 16, 3),
                                 ("hw_event", 4, 2, 4), ("nb_feb", 4, 3, 5),
                                 ("colibri", 4, 1, 6))]
    before = dict(LAUNCHES)
    got = Study.from_specs(specs).run()
    assert LAUNCHES["engine_run"] - before["engine_run"] == 1
    cpu = Study.from_specs(specs).run(device="cpu")
    for spec, r, c in zip(specs, got, cpu):
        assert r.ok and int(r.polls) == 0
        assert cs.swept_diff(r.stats, run(spec).stats,
                             spec.to_params()) == []
        assert cs.int_keys_equal(r.stats, c.stats) == []


@pytest.mark.gpu
def test_batched_launch_runs_blocks_independently(cuda_device):
    """The same point alone and among 200 others in one launch: the same
    bits (no state shared between blocks)."""
    cs = _chip_smoke()
    base = SimParams(protocol="lrscwait", workload="zipf_histogram",
                     zipf_skew=0, n_cores=256, n_addrs=5, cycles=2000,
                     seed=11)
    pts = [base] + [SimParams(protocol=("amo", "lrsc", "colibri")[i % 3],
                              n_cores=256, n_addrs=1 + i % 40,
                              cycles=500 + 10 * i, seed=i)
                    for i in range(200)]
    before = LAUNCHES["engine_run"]
    many = sim.simulate_batch(pts, cuda_device)
    alone = sim.simulate_batch([base], cuda_device)[0]
    torch.cuda.synchronize()
    assert LAUNCHES["engine_run"] == before + 2
    assert cs.result_diff(many[0], alone) == []


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(513, 1, 4, "float32"),
                                   (2048, 300, 16, "bfloat16"),
                                   (150_414, 64, 1, "float32")])
def test_scatter_kernel_matches_plain_version(shape, cuda_device):
    cs = _chip_smoke()
    t, bins, d, dtype = shape
    keys, vals = cs.scatter_inputs(cuda_device, t, bins, d, dtype, seed=t)
    keys[::7] = bins                             # dropped by both
    before = LAUNCHES["colibri_scatter"]
    out = colibri_scatter.colibri_scatter_add(keys, vals, bins)
    hist = colibri_scatter.colibri_histogram(keys, bins)
    torch.cuda.synchronize()
    assert LAUNCHES["colibri_scatter"] == before + 2
    ref = colibri_scatter.scatter_add_ref(keys, vals, bins)
    rtol, atol = cs.SCATTER_TOL[dtype]
    assert out.dtype == vals.dtype
    assert torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)
    assert torch.equal(hist, colibri_scatter.histogram_ref(keys, bins))


def _scatter_keys(kind, dev):
    """Keys of the scatter kernel's edge cases, on the card."""
    cs = _chip_smoke()
    if kind == "skewed":                   # Zipf, exponent 2: 61 % in bin 0
        keys = torch.from_numpy(cs.skewed_keys(*cs.SCATTER_SKEW, seed=3))
    elif kind == "both_ends":              # negative and >= bins, dropped
        g = torch.Generator().manual_seed(5)
        keys = torch.randint(-4, 68, (100_003,), generator=g,
                             dtype=torch.int32)
    elif kind == "none_in_range":
        keys = torch.tensor([-2] * 5000 + [64] * 7000, dtype=torch.int32)
    else:                                  # "empty"
        keys = torch.zeros(0, dtype=torch.int32)
    return keys.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["skewed", "both_ends", "none_in_range",
                                  "empty"])
def test_scatter_kernel_edge_streams(kind, dtype, cuda_device):
    """The skewed 2^20-key stream, keys out of range at both ends, none
    in range, and T = 0, against ``scatter_add_ref`` and
    ``histogram_ref``; two calls give the same bits."""
    cs = _chip_smoke()
    bins = 64
    keys = _scatter_keys(kind, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    vals = torch.randn((keys.numel(), 3), generator=g,
                       device=cuda_device).to(getattr(torch, dtype))
    before = LAUNCHES["colibri_scatter"]
    out = colibri_scatter.colibri_scatter_add(keys, vals, bins)
    again = colibri_scatter.colibri_scatter_add(keys, vals, bins)
    hist = colibri_scatter.colibri_histogram(keys, bins)
    torch.cuda.synchronize()
    assert LAUNCHES["colibri_scatter"] == before + 3
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert torch.equal(out.view(bits), again.view(bits))
    ref = colibri_scatter.scatter_add_ref(keys, vals, bins)
    rtol, atol = cs.SCATTER_TOL[dtype]
    assert out.dtype == vals.dtype and tuple(out.shape) == (bins, 3)
    assert torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)
    assert torch.equal(hist, colibri_scatter.histogram_ref(keys, bins))
    if kind in ("none_in_range", "empty"):
        assert not out.float().any() and not hist.any()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 8])
def test_scatter_commit_is_deterministic(d, cuda_device):
    """Every float sum's order is fixed by chunk and lane: repeated
    commits of one skewed stream (its long segment summed across ~160
    chunks) give the same bits, on one stream and on another."""
    from repro_torch.kernels.colibri_scatter.kernel import \
        scatter_commit_cuda
    cs = _chip_smoke()
    t, bins = cs.SCATTER_SKEW
    keys = _scatter_keys("skewed", cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    vals = torch.randn((t, d), generator=g, device=cuda_device)
    first = scatter_commit_cuda(keys, vals, bins)
    runs = [scatter_commit_cuda(keys, vals, bins) for _ in range(5)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs.append(scatter_commit_cuda(keys, vals, bins))
    torch.cuda.synchronize()
    for r in runs:
        assert torch.equal(r.view(torch.int32), first.view(torch.int32))
    ref = colibri_scatter.scatter_add_ref(keys, vals, bins)
    rtol, atol = cs.SCATTER_TOL["float32"]
    assert torch.allclose(first, ref, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 200, 200, 4, 2, 32, True, "float32"),
                                   (2, 64, 256, 2, 1, 64, False, "bfloat16"),
                                   (4, 512, 512, 10, 1, 256, True,
                                    "bfloat16"),
                                   (4, 512, 512, 10, 1, 256, False,
                                    "bfloat16"),
                                   (1, 100, 100, 8, 2, 112, False,
                                    "bfloat16"),
                                   (4, 512, 512, 64, 8, 112, True,
                                    "bfloat16"),
                                   (4, 512, 512, 64, 8, 112, False,
                                    "bfloat16"),
                                   (2, 64, 64, 64, 8, 112, True, "float32")])
def test_flash_kernel_matches_plain_version(shape, cuda_device):
    cs = _chip_smoke()
    b, sq, skv, h, kv, hd, causal, dtype = shape
    q, k, v = cs.flash_inputs(cuda_device, b, sq, skv, h, kv, hd, dtype,
                              seed=sq)
    before = LAUNCHES["flash_attention"]
    out = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    ref = flash_attention.flash_attention_ref(q, k, v, causal=causal)
    rtol, atol = cs.FLASH_TOL[dtype]
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)


#: (b, s, h, kv, hd, hdv, window, dtype), causal: chip_smoke's band and
#: window past the sequence, MLA's 192/128 ragged, and a band of 50 keys
#: (not a multiple of the 32-key tile) with GQA
FLASH_WINDOW_CASES = [(2, 6144, 10, 1, 256, 256, 2048, "bfloat16"),
                      (2, 512, 10, 1, 256, 256, 4096, "float32"),
                      (1, 777, 16, 16, 192, 128, 0, "float32"),
                      (1, 777, 16, 16, 192, 128, 0, "bfloat16"),
                      (2, 300, 4, 1, 64, 64, 50, "bfloat16"),
                      (2, 300, 4, 1, 64, 64, 50, "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FLASH_WINDOW_CASES)
def test_flash_window_and_mla_kernel_match_plain_version(shape,
                                                         cuda_device):
    """One launch each, within FLASH_TOL of the plain version; a window
    past the sequence gives the causal kernel's bits."""
    cs = _chip_smoke()
    b, s, h, kv, hd, hdv, window, dtype = shape
    q, k, v = cs.flash_inputs(cuda_device, b, s, s, h, kv, hd, dtype,
                              seed=s + window, hdv=hdv)
    before = LAUNCHES["flash_attention"]
    out = flash_attention.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == q.dtype and tuple(out.shape) == (b, s, h, hdv)
    ref = flash_attention.flash_attention_ref(q, k, v, window=window)
    rtol, atol = cs.FLASH_TOL[dtype]
    assert torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)
    if window >= s:
        assert torch.equal(out, flash_attention.flash_attention(q, k, v))


#: (b, sq, skv, h, kv, hd, causal, dtype): whisper-large-v3's encoder
#: over 1 500 frames and its cross-attention (128 positions against the
#: frames), non-causal, and its decoder's causal self-attention, at the
#: whisper_serve_a/b shapes too; and phi-3-vision-4.2b's head dim 96,
#: causal (phi_serve_a/b's shapes among them) and ragged non-causal with
#: GQA
FLASH_SLICE_CASES = [(1, 1500, 1500, 20, 20, 64, False, "bfloat16"),
                     (1, 1500, 1500, 20, 20, 64, False, "float32"),
                     (4, 1500, 1500, 20, 20, 64, False, "bfloat16"),
                     (4, 128, 128, 20, 20, 64, True, "bfloat16"),
                     (2, 64, 64, 20, 20, 64, True, "float32"),
                     (2, 64, 1500, 20, 20, 64, False, "float32"),
                     (2, 512, 512, 32, 32, 96, True, "float32"),
                     (2, 128, 1500, 20, 20, 64, False, "bfloat16"),
                     (2, 128, 1500, 20, 20, 64, False, "float32"),
                     (2, 512, 512, 32, 32, 96, True, "bfloat16"),
                     (1, 300, 300, 8, 8, 96, True, "float32"),
                     (1, 100, 100, 4, 2, 96, False, "bfloat16"),
                     (1, 100, 100, 4, 2, 96, False, "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FLASH_SLICE_CASES)
def test_flash_kernel_at_whisper_and_hd96_shapes(shape, cuda_device):
    """One launch each, within FLASH_TOL of the plain version."""
    cs = _chip_smoke()
    b, sq, skv, h, kv, hd, causal, dtype = shape
    q, k, v = cs.flash_inputs(cuda_device, b, sq, skv, h, kv, hd, dtype,
                              seed=sq + hd)
    before = LAUNCHES["flash_attention"]
    out = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = flash_attention.flash_attention_ref(q, k, v, causal=causal)
    rtol, atol = cs.FLASH_TOL[dtype]
    assert torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("name,launches", [("whisper-large-v3-smoke", 6),
                                           ("phi-3-vision-4.2b-smoke", 2)])
def test_encdec_and_vlm_prefill_on_the_card_match_the_cpu(name, launches,
                                                          cuda_device):
    """The smoke models seeded on the card, copied to the CPU: prefill's
    hidden states on seeded frame or patch embeddings (8 patches over 12
    tokens) within 2e-3, with ``launches`` flash launches (whisper: 2
    encoder layers, 2 decoder layers' self- and cross-attention), and the
    next decode step's logits too."""
    cs = _chip_smoke()
    cfg = get_config(name)
    card = build(cfg).init(1)
    cpu = build(cfg, "cpu").load_params(card.params())
    toks = torch.from_numpy(cs.prompts(cfg.vocab_size, 2, 12, seed=2))
    sa = dict(requests=2, seed=3)
    feats = {k: torch.from_numpy(v)
             for k, v in cs.frontend_feats(cfg, sa).items()}
    before = LAUNCHES["flash_attention"]
    hc, cc = card.prefill(toks.to(cuda_device), 16,
                          **{k: v.to(cuda_device) for k, v in feats.items()})
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + launches
    hp, cp = cpu.prefill(toks, 16, **feats)
    assert torch.allclose(hc.cpu(), hp, rtol=2e-3, atol=2e-3)
    tok, pos = toks[:, -1:], torch.full((2,), 12, dtype=torch.int32)
    lc, _ = card.decode_step(cc, tok.to(cuda_device), pos.to(cuda_device))
    lp, _ = cpu.decode_step(cp, tok, pos)
    assert LAUNCHES["flash_attention"] == before + launches
    assert torch.allclose(lc.cpu(), lp, rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["phase_mla_serve_a", "phase_long_serve_a",
                                   "phase_whisper_serve_a",
                                   "phase_phi_serve_a"])
def test_serve_a_phases_hold_the_card_to_the_cpu(phase, cuda_device):
    """deepseek-v3-671b (MLA, 2 layers, 32 experts), recurrentgemma-2b
    past its window (2 x 4 096 tokens), whisper-large-v3 (2 + 2 layers,
    seeded frames) and phi-3-vision-4.2b (2 layers, 256 seeded patches) at
    full width, f32: the card's logits within SERVE_A_TOL of the port's
    CPU run, launches exact (the phase raises ``chip_smoke.Failed``
    otherwise)."""
    cs = _chip_smoke()
    got = getattr(cs, phase)(cuda_device)
    assert np.isfinite(got["max_abs_err"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(100, 3, 60), (512, 4, 2560)])
def test_rglru_kernel_matches_plain_version(shape, cuda_device):
    cs = _chip_smoke()
    a, x, h0 = cs.rglru_inputs(cuda_device, *shape, seed=shape[0])
    before = LAUNCHES["rglru_scan"]
    out = rglru_scan.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan"] == before + 1
    rtol, atol = cs.RGLRU_TOL
    assert torch.allclose(out, rglru_scan.rglru_scan_ref(a, x, h0),
                          rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["batch_major", "offset"])
@pytest.mark.parametrize("shape", [(1, 2, 60), (65, 3, 6), (130, 2, 200),
                                   (512, 4, 2560)])
def test_rglru_kernel_takes_strided_and_unaligned_inputs(shape, layout,
                                                         cuda_device):
    """The model's (T, B, w) views of (B, T, w) tensors, and inputs off
    16-byte boundaries (staged by the threads, not by TMA): one launch
    each, h with a's strides, the plain version's values."""
    cs = _chip_smoke()
    a, x, h0 = cs.rglru_inputs(cuda_device, *shape, seed=shape[0] + 1)
    if layout == "batch_major":
        aa, xx = cs.batch_major(a), cs.batch_major(x)
    else:
        def offset(y):
            flat = torch.empty(y.numel() + 1, device=cuda_device)
            flat[1:] = y.reshape(-1)
            return flat[1:].view(y.shape)
        aa, xx = offset(a), offset(x)
    before = LAUNCHES["rglru_scan"]
    out = rglru_scan.rglru_scan(aa, xx, h0)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan"] == before + 1
    assert out.stride() == aa.stride()
    rtol, atol = cs.RGLRU_TOL
    assert torch.allclose(out, rglru_scan.rglru_scan_ref(a, x, h0),
                          rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("decay", [-5.0, 1.0])
@pytest.mark.parametrize("shape", [(1, 1, 2, 64), (2, 63, 2, 32),
                                   (1, 65, 2, 64), (2, 17, 1, 16)])
def test_rwkv_kernel_at_its_chunk_edges(shape, decay, cuda_device):
    """One step, T a 64-step chunk +- 1 and a ragged 16-step sub-tile,
    each head dim: out and the final state within RWKV_TOL."""
    cs = _chip_smoke()
    ins = cs.rwkv_inputs(cuda_device, *shape, decay, seed=shape[1] + 3)
    out, state = rwkv6_wkv.wkv(*ins)
    ref_out, ref_state = rwkv6_wkv.wkv_ref(*ins)
    rtol, atol = cs.RWKV_TOL
    assert torch.allclose(out, ref_out, rtol=rtol, atol=atol)
    assert torch.allclose(state, ref_state, rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_served_batch_goes_through_both_kernels(cuda_device):
    """recurrentgemma-2b-smoke (4 rglru, 2 local layers): each prefill
    launches 4 rglru_scan and 2 flash_attention kernels, decode none."""
    cs = _chip_smoke()
    cfg = get_config("recurrentgemma-2b-smoke")
    model = build(cfg).init(0)
    eng = ServeEngine(cfg, model, batch_size=2, cache_len=24)
    probe = cs.Probe(model)
    toks = cs.prompts(cfg.vocab_size, 2, 16, seed=1)
    tokens = cs.serve(eng, toks, 4)
    assert tokens.shape == (2, 4)
    (pre,) = probe.calls["prefill"]
    assert pre["finite"]
    assert pre["launches"]["flash_attention"] == 2
    assert pre["launches"]["rglru_scan"] == 4
    assert len(probe.calls["decode_step"]) == 4
    for call in probe.calls["decode_step"]:
        assert call["finite"]
        assert call["launches"]["flash_attention"] == 0
        assert call["launches"]["rglru_scan"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("decay", [-5.0, 1.0])
@pytest.mark.parametrize("shape", [(2, 130, 2, 64), (1, 32, 1, 16),
                                   (4, 512, 32, 64)])
def test_rwkv_kernel_matches_plain_version(shape, decay, cuda_device):
    cs = _chip_smoke()
    ins = cs.rwkv_inputs(cuda_device, *shape, decay, seed=shape[1])
    before = LAUNCHES["rwkv6_wkv"]
    out, state = rwkv6_wkv.wkv(*ins)
    torch.cuda.synchronize()
    assert LAUNCHES["rwkv6_wkv"] == before + 1
    ref_out, ref_state = rwkv6_wkv.wkv_ref(*ins)
    rtol, atol = cs.RWKV_TOL
    assert torch.allclose(out, ref_out, rtol=rtol, atol=atol)
    assert torch.allclose(state, ref_state, rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_served_rwkv_batch_goes_through_the_kernel(cuda_device):
    """rwkv6-1.6b-smoke (2 rwkv layers): each prefill launches 2
    rwkv6_wkv kernels, decode none."""
    cs = _chip_smoke()
    cfg = get_config("rwkv6-1.6b-smoke")
    model = build(cfg).init(0)
    eng = ServeEngine(cfg, model, batch_size=2, cache_len=24)
    probe = cs.Probe(model)
    toks = cs.prompts(cfg.vocab_size, 2, 16, seed=1)
    tokens = cs.serve(eng, toks, 4)
    assert tokens.shape == (2, 4)
    (pre,) = probe.calls["prefill"]
    assert pre["finite"]
    assert cs.lm_launches_ok(pre["launches"], {"rwkv6_wkv": 2})
    assert len(probe.calls["decode_step"]) == 4
    for call in probe.calls["decode_step"]:
        assert call["finite"]
        assert cs.lm_launches_ok(call["launches"], {})


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((4, 64, 128, 256), "float32"),
                                         ((8, 100, 96, 64), "bfloat16"),
                                         ((1, 256, 512, 128), "bfloat16"),
                                         ((3, 37, 100, 70), "float32"),
                                         ((3, 37, 100, 70), "bfloat16"),
                                         ((16, 8, 7168, 2048), "bfloat16"),
                                         ((16, 8, 2048, 7168), "bfloat16"),
                                         ((16, 56, 7168, 2048), "bfloat16")])
def test_gmm_kernel_matches_plain_version(shape, dtype, cuda_device):
    cs = _chip_smoke()
    x, w = cs.gmm_inputs(cuda_device, *shape, dtype, seed=shape[1])
    before = LAUNCHES["grouped_matmul"]
    out = grouped_matmul.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_matmul"] == before + 1
    ref = grouped_matmul.grouped_matmul_ref(x, w)
    rtol, atol = cs.GMM_TOL[dtype]
    assert out.dtype == x.dtype
    assert tuple(out.shape) == (shape[0], shape[1], shape[3])
    assert torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_served_moe_batch_goes_through_the_kernels(cuda_device):
    """kimi-k2-1t-a32b-smoke (a dense and an MoE layer): each prefill
    launches 2 flash_attention and 3 grouped_matmul kernels, each decode
    step 3 grouped_matmul kernels."""
    cs = _chip_smoke()
    cfg = get_config("kimi-k2-1t-a32b-smoke")
    model = build(cfg).init(0)
    eng = ServeEngine(cfg, model, batch_size=2, cache_len=24)
    probe = cs.Probe(model)
    toks = cs.prompts(cfg.vocab_size, 2, 16, seed=1)
    tokens = cs.serve(eng, toks, 4)
    assert tokens.shape == (2, 4)
    (pre,) = probe.calls["prefill"]
    assert pre["finite"]
    assert cs.lm_launches_ok(pre["launches"], cs.MOE_SERVE_B_LAUNCHES)
    assert len(probe.calls["decode_step"]) == 4
    for call in probe.calls["decode_step"]:
        assert call["finite"]
        assert cs.lm_launches_ok(call["launches"], cs.MOE_DECODE_LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 512, 512, 64, 8, 112, True),
                                   (4, 512, 512, 10, 1, 256, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_result_does_not_depend_on_the_batch(shape, dtype,
                                                          cuda_device):
    """A request's rows are the same bits alone as in its batch, in both
    designs (serve_b and moe_serve_b report ``solo_agrees``)."""
    cs = _chip_smoke()
    b, sq, skv, h, kv, hd, causal = shape
    q, k, v = cs.flash_inputs(cuda_device, b, sq, skv, h, kv, hd, dtype,
                              seed=hd)
    out = flash_attention.flash_attention(q, k, v, causal=causal)
    one = flash_attention.flash_attention(q[1:2].contiguous(),
                                          k[1:2].contiguous(),
                                          v[1:2].contiguous(), causal=causal)
    assert torch.equal(one, out[1:2])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 56, 7168, 2048), (16, 8, 2048, 7168)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_kernel_result_does_not_depend_on_the_slots(shape, dtype,
                                                        cuda_device):
    """An expert's slots give the same bits in a smaller buffer, at other
    positions (a smaller batch routes them so): the sum over d runs in
    one order whatever C is."""
    cs = _chip_smoke()
    x, w = cs.gmm_inputs(cuda_device, *shape, dtype, seed=shape[1])
    out = grouped_matmul.grouped_matmul(x, w)
    some = torch.arange(shape[1] // 4 - 1, -1, -1, device=cuda_device)
    assert torch.equal(grouped_matmul.grouped_matmul(x[:, some].contiguous(),
                                                     w), out[:, some])


@pytest.mark.gpu
@pytest.mark.parametrize("name", PROTOS)
def test_model_check_with_the_step_kernel(name, cuda_device):
    """The quick model check with engine_step_kernel as the fused twin:
    0 findings, the counts of the check with fused_access, one launch a
    distinct delivery (``chip_smoke.py``'s model_check phase runs the
    full gate)."""
    from repro_torch.analysis import model_check
    want = model_check.check_protocol(name, quick=True)
    seam = model_check.HookDriver.fused_side
    model_check.HookDriver.fused_side = model_check.stepped(
        engine_step.fused_step, cuda_device)
    before = LAUNCHES["engine_step"]
    try:
        got = model_check.check_protocol(name, quick=True)
    finally:
        model_check.HookDriver.fused_side = seam
    assert got.ok, [f.render() for f in got.findings]
    assert (got.stats["states"], got.stats["transitions"]) == (
        want.stats["states"], want.stats["transitions"])
    assert LAUNCHES["engine_step"] > before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 200, 200, 9, 3, 64, True, "bfloat16"),
                                   (1, 130, 95, 4, 1, 128, False, "float32"),
                                   (1, 100, 100, 8, 2, 112, True, "bfloat16"),
                                   (2, 70, 70, 4, 2, 32, True, "float32"),
                                   (2, 70, 70, 4, 2, 32, True, "bfloat16")])
def test_flash_backward_kernel_matches_plain_version(shape, cuda_device):
    """dq, dk, dv and the forward's lse against the plain versions; two
    backward launches give the same bits; the forward with lse gives the
    bits of the forward without (``chip_smoke.flash_bwd_check``)."""
    cs = _chip_smoke()
    before = dict(LAUNCHES)
    rec = cs.flash_bwd_check(cuda_device, shape, seed=shape[1])
    assert LAUNCHES["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 2
    assert LAUNCHES["flash_attention_bwd_dkdv"] == \
        before["flash_attention_bwd_dkdv"] + 2
    assert rec["lse_err"] <= cs.FLASH_LSE_TOL[shape[-1]]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,window", [
    ((1, 300, 300, 8, 8, 80, True, "bfloat16"), 0),
    ((1, 300, 300, 8, 8, 96, True, "float32"), 0),
    ((1, 70, 260, 4, 4, 64, False, "bfloat16"), 0),
    ((1, 400, 400, 10, 1, 256, True, "bfloat16"), 130),
    ((1, 333, 333, 4, 2, 64, True, "bfloat16"), 100)])
def test_flash_backward_window_and_new_head_dims(shape, window, cuda_device):
    """hd 80, 96 and 256, Sq < Skv non-causal and the band: the backward
    against its plain version (``chip_smoke.flash_bwd_check``)."""
    cs = _chip_smoke()
    rec = cs.flash_bwd_check(cuda_device, shape, seed=shape[1], window=window)
    assert rec["lse_err"] <= cs.FLASH_LSE_TOL[shape[-1]]


@pytest.mark.gpu
def test_rglru_gradient_runs_the_kernel(cuda_device):
    """A gradient through the scan on CUDA tensors: one forward and one
    gradient launch, the gradients the plain version's."""
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_ref
    cs = _chip_smoke()
    a, x, h0 = cs.rglru_inputs(cuda_device, 200, 2, 300, 3)
    a, x = (cs.batch_major(t).requires_grad_() for t in (a, x))
    before = dict(LAUNCHES)
    h = rglru_scan.rglru_scan(a, x, h0)
    dh = torch.randn_like(h)
    h.backward(dh)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan"] - before["rglru_scan"] == 1
    assert LAUNCHES["rglru_scan_bwd"] - before["rglru_scan_bwd"] == 1
    want = rglru_scan_bwd_ref(a.detach(), h.detach(), h0, dh)
    for g, w in zip((a.grad, x.grad), want):
        assert torch.allclose(g, w, rtol=1e-4,
                              atol=1e-4 * float(w.abs().max()))


@pytest.mark.gpu
def test_flash_autograd_op_runs_the_kernels(cuda_device):
    """A gradient through the op on CUDA tensors: the lse forward kernel
    and the two backward kernels, once each; the gradients equal the
    backward kernel's own."""
    from repro_torch.kernels.flash_attention import kernel as fa
    cs = _chip_smoke()
    q, k, v = (t.requires_grad_() for t in cs.flash_inputs(
        cuda_device, 2, 64, 64, 4, 2, 64, "bfloat16", seed=9))
    before = dict(LAUNCHES)
    out = flash_attention.flash_attention(q, k, v, causal=True)
    do = torch.randn_like(out)
    out.backward(do)
    torch.cuda.synchronize()
    assert {k_: LAUNCHES[k_] - before[k_] for k_ in (
        "flash_attention", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv")} == {
        "flash_attention": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkdv": 1}
    o, lse = fa.flash_attention_fwd_lse_cuda(q.detach(), k.detach(),
                                             v.detach(), causal=True)
    want = fa.flash_attention_bwd_cuda(q.detach(), k.detach(), v.detach(),
                                       o, do, lse, causal=True)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_flash_backward_refuses_other_head_dims(cuda_device):
    from repro_torch.kernels.flash_attention import kernel as fa
    cs = _chip_smoke()
    q, k, v = cs.flash_inputs(cuda_device, 1, 16, 16, 2, 1, 48, "bfloat16",
                              seed=1)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention.FlashAttention.apply(q.requires_grad_(), k, v, True)
    lse = torch.zeros(1, 2, 16, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention_bwd_cuda(q.detach(), k, v, q.detach(), q.detach(),
                                    lse)


@pytest.mark.gpu
def test_training_smoke_resumes_bit_identical(cuda_device, tmp_path):
    """smollm-135m-smoke through run_training on the card: the kernels'
    launches, and a crash then resume equal to the uninterrupted run."""
    from repro_torch.tree import flatten
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.train import TrainRun, run_training
    kw = dict(cfg=get_config("smollm-135m-smoke"),
              shape=ShapeSpec("smoke", 128, 4, "train"), steps=6,
              ckpt_every=2, log_every=100, device="cuda")
    before = dict(LAUNCHES)
    ref = run_training(TrainRun(ckpt_dir=str(tmp_path / "a"), **kw))
    assert LAUNCHES["flash_attention_bwd_dq"] - \
        before["flash_attention_bwd_dq"] == 6 * 2
    run_b = TrainRun(ckpt_dir=str(tmp_path / "b"), **kw)
    with pytest.raises(RuntimeError, match="simulated failure"):
        run_training(run_b, crash_at=3)
    resumed = run_training(run_b, resume=True)
    for (p, a), (_, b) in zip(flatten(ref["params"]),
                              flatten(resumed["params"])):
        assert torch.equal(a, b), p
