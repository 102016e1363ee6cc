"""The port's public API: golden values, Spec JSON, and chip_smoke's
embedded reference values.

``repro_torch.sync.run`` on the CPU reproduces the reference suite's
``GOLDEN``/``GOLDEN_EXTRA`` values (``tests/test_protocols.py``) for the
ported protocols that have them exactly; a ``Spec`` written by either
package loads in the other; and the reference values ``chip_smoke.py``
holds the GPU run against are recomputed here with the JAX package, so
they cannot drift.
"""
import hashlib
import importlib.util
import json
from pathlib import Path

import pytest
import torch

import repro.sync as jsync
from repro_torch import sync as tsync
from repro_torch.core import protocols as tprotocols
from repro_torch.core.sim import SimParams
from repro_torch.kernels import engine_step
from test_protocols import GOLDEN, GOLDEN_CONFIGS, GOLDEN_EXTRA, _observe
from jax_cache import release_compiled  # noqa: F401

PROTOS = ("amo", "lrsc", "lrscwait", "colibri", "amo_lock", "lrsc_lock",
          "mwait_lock")
#: what the port registers, sorted
PORTED = ("amo, amo_lock, colibri, colibri_hier, hw_event, lrsc, lrsc_lock, "
          "lrscwait, mwait_lock, nb_feb, ticket_lock")
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("proto", PROTOS)
def test_run_matches_seed_golden(proto):
    for i, cfg in enumerate(GOLDEN_CONFIGS):
        r = tsync.run(tsync.Spec(protocol=proto, **cfg), device="cpu")
        obs = _observe(r.stats)
        want = GOLDEN[f"{proto}/{i}"]
        assert {k: obs[k] for k in want} == want, (proto, i)


@pytest.mark.parametrize("name", sorted(GOLDEN_EXTRA))
def test_run_matches_seed_golden_extra(name):
    cfg, want = GOLDEN_EXTRA[name]
    cfg = dict(cfg)
    proto = cfg.pop("protocol", "lrscwait")
    r = tsync.run(protocol=proto, device="cpu", **cfg)
    obs = _observe(r.stats)
    assert {k: obs[k] for k in want} == want, name


def test_run_metrics_equal_reference_exactly():
    kw = dict(protocol="colibri", workload="zipf_histogram", zipf_skew=0,
              n_cores=32, n_addrs=4, cycles=800, seed=2)
    want = jsync.run(jsync.Spec(backend="xla_cpu", **kw))
    got = tsync.run(tsync.Spec(**kw), device="cpu")
    assert got.metrics() == want.metrics()
    assert got.to_row() == want.to_row()
    assert got.throughput == want.throughput
    assert got.jain_fairness == want.jain_fairness
    assert got.energy_pj_per_op == want.energy_pj_per_op
    assert got.check() == want.check()


# ---------------------------------------------------------------------------
# Spec JSON: either package loads the other's
# ---------------------------------------------------------------------------

SPECS = [
    dict(),
    dict(protocol="lrscwait", q_slots=8, n_cores=64, n_addrs=16, lat=3),
    dict(protocol="lrsc", workload="zipf_histogram", zipf_skew=0,
         n_workers=8, net_bw=13, cycles=3000, seed=5),
]


@pytest.mark.parametrize("kw", SPECS)
def test_spec_json_round_trips_both_ways(kw):
    ref = jsync.Spec(**kw)
    port = tsync.Spec.from_json(ref.to_json())
    assert port.to_dict() == ref.to_dict()
    assert jsync.Spec.from_json(port.to_json()) == ref
    assert tsync.Spec.from_json(port.to_json()) == port
    assert port.to_params().n_cores == ref.to_params().n_cores


def test_spec_with_unported_feature_fails_in_the_port():
    # every protocol loads; an unknown one lists them all
    for name in PORTED.split(", "):
        ref = jsync.Spec(protocol=name, n_groups=3)
        assert tsync.Spec.from_json(ref.to_json()).to_dict() \
            == ref.to_dict()
    with pytest.raises(ValueError) as e:
        tsync.Spec(protocol="no_such_protocol")
    assert PORTED in str(e.value)
    ref = jsync.Spec(workload="ms_queue", n_addrs=2)
    port = tsync.Spec.from_json(ref.to_json())
    assert port.to_dict() == ref.to_dict()
    assert jsync.Spec.from_json(port.to_json()) == ref
    ref = jsync.Spec(workload="zipf_histogram", zipf_skew=150,
                     topology="cluster3")
    assert tsync.Spec.from_json(ref.to_json()).to_dict() == ref.to_dict()
    ref = jsync.Spec(faults={"n_kill": 1, "watchdog_cyc": 64,
                             "msg_drop_bp": 25})
    port = tsync.Spec.from_json(ref.to_json())
    assert port.to_dict() == ref.to_dict() and port.faults.enabled
    assert jsync.Spec.from_json(port.to_json()) == ref


def test_result_json_round_trip():
    r = tsync.run(protocol="amo", n_cores=8, cycles=200, device="cpu")
    back = tsync.Result.from_json(r.to_json())
    assert back.metrics() == json.loads(r.to_json())["metrics"]
    assert back.spec == r.spec


def test_run_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsync.run(protocol="amo", n_cores=8, cycles=10)


def test_registries_and_scenarios():
    assert tsync.protocols() == tuple(PORTED.split(", "))
    assert tsync.workloads() == jsync.workloads()
    for wl in tsync.workloads():
        assert tsync.scenario(wl) == jsync.scenario(wl)


# ---------------------------------------------------------------------------
# chip_smoke.py's embedded reference values
# ---------------------------------------------------------------------------

def test_chip_smoke_reference_values_match_the_reference():
    cs = _chip_smoke()
    assert cs.GOLDEN_CONFIGS == GOLDEN_CONFIGS
    assert cs.GOLDEN == {k: v for k, v in GOLDEN.items()
                         if k.split("/")[0] in PROTOS}
    assert cs.GOLDEN_EXTRA == GOLDEN_EXTRA
    assert set(cs.FULL_WIDTH_REF) == {f"{p}/{n}/{b}"
                                      for p, n, b in cs.FULL_WIDTH_POINTS}
    for name, n, bins in cs.FULL_WIDTH_POINTS:
        spec = cs.full_width_spec(name, n, bins)
        ref = jsync.run(jsync.Spec.from_json(spec.to_json()).replace(
            backend="xla_cpu"))
        assert cs.full_width_summary(ref.stats) \
            == cs.FULL_WIDTH_REF[f"{name}/{n}/{bins}"], (name, n, bins)


def test_chip_smoke_checks_the_kernel_at_every_shape_it_launches():
    """Every (cores, banks) the golden, main and sweep phases launch (a
    swept point at its bank bucket) is a KERNEL_SHAPES entry, where the
    run_kernel phase holds the kernel against the plain loop."""
    from repro_torch.core.sweep import _bucket_a
    cs = _chip_smoke()
    launched = {(c["n_cores"], c["n_addrs"]) for c in GOLDEN_CONFIGS}
    launched |= {(c["n_cores"], c["n_addrs"])
                 for c, _ in GOLDEN_EXTRA.values()}
    launched |= {(n, b) for _, n, b in cs.FULL_WIDTH_POINTS}
    swept = [s.to_params() for s in cs.sweep_fig3_specs()
             + cs.sweep_mixed_specs() + cs.fig4_specs() + cs.hier_specs()]
    launched |= {(p.n_cores, _bucket_a(p.n_addrs)) for p in swept}
    assert launched <= set(cs.KERNEL_SHAPES)
    assert (2048, 512) in cs.KERNEL_SHAPES


def test_chip_smoke_fig4_is_the_bench_locks_grid():
    """The fig4 phase runs ``benchmarks/bench_locks.py``'s grid at its
    full length: its protocols × bins, 256 cores, the locks with the
    fixed 128-cycle backoff, one core count (one launch)."""
    import sys
    sys.path.insert(0, str(ROOT))
    from benchmarks import bench_locks
    cs = _chip_smoke()
    assert cs.FIG4_LOCKS == bench_locks.LOCKS
    assert cs.SWEEP_BINS == bench_locks.BINS
    assert cs.FIG4_CYCLES == 12_000
    want = [jsync.Spec(protocol=pr, n_addrs=b, cycles=cs.FIG4_CYCLES,
                       **(dict(backoff=128, backoff_exp=1)
                          if pr.endswith("lock") else {}))
            for pr in bench_locks.LOCKS for b in bench_locks.BINS]
    got = cs.fig4_specs()
    assert [g.to_dict() for g in got] == [
        tsync.Spec.from_json(w.to_json()).to_dict() for w in want]
    assert {g.to_params().n_cores for g in got} == {256}
    assert set(cs.LOCK_TIME_POINTS) == {(pr, 256, 1)
                                        for pr in bench_locks.LOCKS}


def test_chip_smoke_faults_is_the_bench_faults_grid(monkeypatch):
    """The faults phase's Study holds ``benchmarks/bench_faults.py``'s
    points at their full size, in its order (each protocol's healthy
    run first), all of one core count (one launch), and derives its rows
    and headline as the benchmark does: both run on the same stand-in
    results give the same rows, named as the committed report's."""
    import sys
    sys.path.insert(0, str(ROOT))
    from benchmarks import bench_faults
    cs = _chip_smoke()

    class Stub:
        def __init__(self, spec):
            key = json.dumps(spec.to_dict(), sort_keys=True)
            h = int(hashlib.sha256(key.encode()).hexdigest()[:8], 16)
            self.spec, self.throughput = spec, (h % 97) / 100
            self.stats = {"survivor_throughput": (h % 89) / 100}
            self.ok = h % 3 > 0

        def to_row(self, **extra):
            return dict(extra, protocol=self.spec.protocol.name,
                        progress_ok=self.ok, throughput=self.throughput)

    seen = []

    def fake_run(spec):
        seen.append(spec.to_dict())
        return Stub(spec)

    monkeypatch.setattr(bench_faults, "run", fake_run)
    want_rows = bench_faults.rows()
    want_head = bench_faults.headline(want_rows)
    names, specs = cs.fault_specs()
    assert [s.to_dict() for s in specs] == [
        tsync.Spec.from_json(jsync.Spec.from_dict(d).to_json()).to_dict()
        for d in seen]
    assert {s.to_params().n_cores for s in specs} == {64}
    assert len(specs) == 47 and len(want_rows) == 38
    rows, head = cs.fault_rows({n: Stub(s) for n, s in zip(names, specs)})
    assert rows == want_rows and head == want_head
    ref = json.loads(cs.FAULTS_REPORT.read_text())["faults"]
    assert [r["row"] for r in ref["rows"]] == [r["row"] for r in rows]
    # the report predates the topology group: the reference's row of a
    # faulted point today has its keys and FAULTS_ROW_ADDED's
    one = jsync.run(jsync.Spec(protocol="lrscwait", n_cores=8, cycles=60,
                               faults={"n_kill": 1, "watchdog_cyc": 8}))
    row = one.to_row(**{k: 0 for k in ref["rows"][0]
                        if k not in one.to_row()})
    assert set(row) == set(ref["rows"][0]) | set(cs.FAULTS_ROW_ADDED)
    assert {k: row[k] for k in cs.FAULTS_ROW_ADDED} == cs.FAULTS_ROW_ADDED


def test_chip_smoke_hier_is_one_launch_of_every_group_count():
    """The hier phase's Study: colibri and nb_feb, colibri_hier at 1, 2,
    4, 8 and 16 groups and hw_event at 4, each at the Fig. 3 bins, 256
    cores (one launch), the Fig. 4 phase's cycles; the kernel phases
    also take colibri_hier at 1 and 3 groups."""
    cs = _chip_smoke()
    pts = [s.to_params() for s in cs.hier_specs()]
    assert len(pts) == 48
    assert {p.n_cores for p in pts} == {256}
    assert {p.cycles for p in pts} == {cs.FIG4_CYCLES}
    lines = {(p.protocol, p.n_groups) for p in pts}
    assert {g for pr, g in lines if pr == "colibri_hier"} == {1, 2, 4, 8,
                                                              16}
    assert {pr for pr, _ in lines} == {"colibri", "nb_feb", "colibri_hier",
                                       "hw_event"}
    assert {p.n_addrs for p in pts} == set(cs.SWEEP_BINS)
    assert {(pr, g) for pr, g in cs.PROTO_CASES} >= {
        ("colibri_hier", 1), ("colibri_hier", 3), ("colibri_hier", 4)}
    assert {pr for pr, _ in cs.PROTO_CASES} == set(tprotocols.names())


def test_chip_smoke_sweep_points_are_covered():
    """The sweep phase's points: the Fig. 3 lines at every bin count plus
    the 1024-core point (every FULL_WIDTH_POINTS entry among them, so
    FULL_WIDTH_REF holds them), two launch groups; the mixed grid is one
    core count, varies every DYN_FIELDS field but zipf_skew, pads its
    banks, carries the Fig. 5 workers and a traced point."""
    from repro_torch.core.sim import DYN_FIELDS
    from repro_torch.core.sweep import _bucket_a
    cs = _chip_smoke()
    fig3 = [s.to_params() for s in cs.sweep_fig3_specs()]
    assert len(fig3) == 31
    assert {p.n_cores for p in fig3} == {256, 1024}
    assert cs.SWEEP_FIG3_LAUNCHES == 2
    have = {(p.protocol, p.n_cores, p.n_addrs) for p in fig3}
    assert set(cs.FULL_WIDTH_POINTS) <= have
    assert {p.n_addrs for p in fig3} == set(cs.SWEEP_BINS)
    assert {p.q_slots for p in fig3 if p.protocol == "lrscwait"} == {8, 256}
    mixed = [s.to_params() for s in cs.sweep_mixed_specs()]
    assert len({p.n_cores for p in mixed}) == 1
    for f in DYN_FIELDS:
        vals = {getattr(p, f) for p in mixed}
        assert (len(vals) == 1) == (f == "zipf_skew"), f
    assert any(_bucket_a(p.n_addrs) > p.n_addrs for p in mixed)
    assert {p.n_workers for p in mixed if p.protocol == "lrscwait"
            and p.net_bw == 13 and p.hol_block == 16} >= {0, 64, 128}
    assert any(p.record_trace for p in mixed)


@pytest.mark.parametrize("proto,want", [("amo", 366), ("lrsc", 376)])
def test_chip_smoke_step_bytes_counts_what_the_step_needs(proto, want):
    """8 cores, 2 banks, one acquire at bank 0 by core 3 against a free
    reservation: 8n input bytes, 8 winner bytes plus the read lanes of
    the one requested bank, the changed state, 13a output bytes and the
    67 stat words."""
    cs = _chip_smoke()
    n, a = 8, 2
    p = SimParams(protocol=proto, n_cores=n, n_addrs=a)
    pr = tprotocols.get(proto)
    bank = pr.init_bank_state(p, a, n, n, "cpu")
    i32 = torch.int32
    cand = torch.full((n,), 2**31 - 1, dtype=i32)
    cand[3] = 10
    addr = torch.ones(n, dtype=i32)
    addr[3] = 0
    out = engine_step.fused_step_ref(
        pr, p, bank, cand_cyc=cand, rot=torch.arange(n, dtype=i32),
        addr=addr, phase=torch.zeros(n, dtype=i32),
        acq_start=torch.zeros(n, dtype=i32), core={}, cyc=12, shift=0,
        lat=5, n=n, a=a, q_cap=n, cycles=100)
    assert cs.step_bytes(n, a, bank, out) == want
