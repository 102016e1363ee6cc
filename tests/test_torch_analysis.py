"""``repro_torch.analysis``: the port's model checker, trace checks and
integer-range analyzer, mirroring ``tests/test_analysis.py`` (its jaxpr
cases have no port: the port has no jaxpr).

* **the matrix** — every protocol passes the quick model check, each
  configuration exploring exactly the states and transitions of the
  reference's ``repro.analysis.model_check`` (run here where a
  configuration explores fewer than 2 000 states, held to the
  reference's counts otherwise), and the full gate's per-protocol
  totals equal the reference's;
* **known-bad protocols** — toy plugins seeded with the classic bugs
  (a dropped wakeup, a poller wearing a retry-free contract, a watchdog
  that evicts live owners, an early rejection) each trip exactly the
  rule built to catch them, as subclasses of the port's protocols;
* **mutation checks** — two bugs the reference shipped and fixed (the
  ``wake_grp`` cross-bank aliasing, the stale-owner eviction class) are
  flagged in the port as well;
* the trace checks and the range theorems, each with a seeded failure,
  the CLI, and the package's imports.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import model_check as ref_model_check
from repro_torch.analysis import int_range, model_check, run_passes
from repro_torch.analysis import trace_safety
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.model_check import Config, check_protocol
from repro_torch.analysis.report import (Finding, PassReport, all_findings,
                                         fail_fast, summarize)
from repro_torch.core import sweep
from repro_torch.core.protocols.base import MOD, OUT_EVICT, OUT_NONE, \
    Contract
from repro_torch.core.protocols.colibri_hier import ColibriHier
from repro_torch.core.protocols.lrscwait import LrscWait
from repro_torch.core.protocols.registry import get as proto_get
from repro_torch.core.protocols.registry import names as proto_names
from repro_torch.kernels.engine_step import kernel as es_kernel
from jax_cache import release_compiled  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TINY = [Config(n=2, a=1, ops=1)]
#: the reference's configurations too large to re-explore in a test,
#: with its (states, transitions): ``repro.analysis.model_check.
#: check_protocol(name, configs=[cfg])`` under jax 0.9.0 on the CPU
REF_LARGE = {
    ("colibri_hier", "n=3 a=1 ops=2 q=64 g=2"): (11_956, 18_480),
    ("hw_event", "n=3 a=1 ops=2 q=64 g=2"): (10_482, 16_504),
}
#: the reference's full gate, ``python -m repro.analysis model --json``
#: under jax 0.9.0 on the CPU: (states, transitions) per protocol
REF_FULL = {
    "amo": (44, 78), "amo_lock": (510, 1034), "colibri": (3308, 5622),
    "colibri_hier": (13172, 21192), "hw_event": (15250, 24576),
    "lrsc": (2912, 7100), "lrsc_lock": (510, 1034),
    "lrscwait": (3398, 5746), "mwait_lock": (3308, 5622),
    "nb_feb": (4062, 7434), "ticket_lock": (1844, 4272),
}


def _rules(rep):
    return {f.rule for f in rep.findings}


# ---------------------------------------------------------------------------
# report plumbing
# ---------------------------------------------------------------------------

def test_finding_and_report_plumbing():
    f = Finding("model", "lost-wakeup", "toy", "a sleeper starved",
                where="n=2 a=1")
    assert "model:lost-wakeup" in f.render() and "[n=2 a=1]" in f.render()
    good = PassReport(pass_name="range", subject="backoff")
    bad = PassReport(pass_name="model", subject="toy", findings=[f])
    assert good.ok and not bad.ok
    assert bad.to_dict()["findings"][0]["rule"] == "lost-wakeup"
    json.dumps([good.to_dict(), bad.to_dict()])
    assert all_findings([good, bad]) == [f]
    s = summarize([good, bad])
    assert "ok" in s and "1 finding(s)" in s
    assert "lost-wakeup" in fail_fast([bad], limit=5)
    assert "more" in fail_fast([bad, bad, bad], limit=2)


# ---------------------------------------------------------------------------
# the matrix: every protocol, quick scope, against the reference
# ---------------------------------------------------------------------------

def test_configs_are_the_references():
    for name in proto_names():
        for quick in (False, True):
            assert [dataclasses.asdict(c) for c in
                    model_check.configs_for(name, quick)] == \
                [dataclasses.asdict(c) for c in
                 ref_model_check.configs_for(name, quick)], name
    assert model_check.MAX_STATES == ref_model_check.MAX_STATES


@pytest.mark.parametrize("protocol", proto_names())
def test_model_check_passes_every_protocol(protocol):
    rep = check_protocol(protocol, quick=True)
    assert rep.ok, fail_fast([rep])
    assert rep.stats["states"] > 0 and rep.stats["transitions"] > 0
    for cfg, got in zip(model_check.configs_for(protocol, quick=True),
                        rep.stats["per_config"]):
        want = REF_LARGE.get((protocol, cfg.label()))
        if want is None:
            ref = ref_model_check.check_protocol(
                protocol, configs=[ref_model_check.Config(
                    **dataclasses.asdict(cfg))])
            assert ref.ok
            want = (ref.stats["states"], ref.stats["transitions"])
            assert want[0] < 2_000, (protocol, cfg.label(), want)
        assert (got["states"], got["transitions"]) == want, (protocol,
                                                             cfg.label())


def test_full_gate_equals_the_references():
    reps = model_check.check_all()
    assert all(r.ok for r in reps), fail_fast(reps)
    got = {r.subject: (r.stats["states"], r.stats["transitions"])
           for r in reps}
    assert got == REF_FULL
    assert sum(s for s, _ in got.values()) == 48_318
    assert sum(t for _, t in got.values()) == 83_710


# ---------------------------------------------------------------------------
# known-bad toy protocols: each seeded bug trips exactly its rule
# ---------------------------------------------------------------------------

class _ToyLostWakeup(LrscWait):
    """Releases never arm the wake timer — the queued sleeper starves."""
    name = "toy_lost_wakeup"

    def wake_delay(self, p):
        return 0


class _ToyPoller(LrscWait):
    """One queue slot (held by the grantee) turns every contending
    acquire into an immediate FAIL — polling, while the contract still
    claims the paper's retry-free wait-class behaviour."""
    name = "toy_poller"
    contract = Contract(exclusive_grant=True, wait_class=True,
                        retry_free=True, queue_counts_holder=True,
                        max_hot_scatters=4)

    def q_cap(self, p, n):
        return 1


class _ToyLiveEvictor(LrscWait):
    """Watchdog that evicts the queue head without checking it is dead
    — the stale-owner bug class: a slow-but-live owner loses the
    reservation and the bank double-grants."""
    name = "toy_live_evictor"

    def on_timeout(self, ctx, cs, bank, stuck_b, killed, owner):
        qhead, qlen = bank["qhead"], bank["qlen"]
        evict_b = stuck_b & (qlen > 0)        # BUG: ignores ``killed``
        qhead = torch.where(evict_b, torch.remainder(qhead + 1, ctx.q_cap),
                            qhead)
        qlen = qlen - evict_b.to(torch.int32)
        wake_b = evict_b & (qlen > 0)
        bank = dict(bank, qhead=qhead, qlen=qlen,
                    wake_tmr=bank["wake_tmr"].masked_fill(
                        wake_b, self.wake_delay(ctx.p)))
        return cs, bank, torch.where(evict_b, OUT_EVICT,
                                     OUT_NONE).to(torch.int32)


class _EarlyRejector(LrscWait):
    """Rejects the second waiter with one of two slots free: admission
    sees a capacity of 1 in both forms."""
    name = "toy_early_rejector"

    def q_cap(self, p, n):
        return 2

    def on_access(self, ctx, cs, bank):
        return super().on_access(dataclasses.replace(ctx, q_cap=1), cs,
                                 bank)

    def fused_access(self, fx, bank):
        return super().fused_access(dataclasses.replace(fx, q_cap=1), bank)


@pytest.mark.parametrize("toy,configs,rule", [
    (_ToyLostWakeup(), TINY, "lost-wakeup"),
    (_ToyPoller(), TINY, "retry-free"),
    (_ToyLiveEvictor(), TINY, "live-evict"),
    (_EarlyRejector(), [Config(n=3, a=1, ops=1)], "fail-not-full"),
], ids=["lost-wakeup", "poller", "live-evictor", "fail-requires-full"])
def test_toy_protocol_trips_exactly_its_rule(toy, configs, rule):
    rep = check_protocol(toy, kill=False, configs=configs)
    assert _rules(rep) == {rule}, fail_fast([rep]) or "no findings"


class _Diverging(LrscWait):
    """A fused twin that forgets to arm the successor's wake."""
    name = "toy_diverging"

    def fused_access(self, fx, bank):
        bank, fo = super().fused_access(fx, bank)
        return dict(bank, wake_tmr=bank["wake_tmr"] * 0), fo


class _LaneWriter(LrscWait):
    """An on_access that stamps every core's timer."""
    name = "toy_lane_writer"

    def on_access(self, ctx, cs, bank):
        cs, bank = super().on_access(ctx, cs, bank)
        cs["tmr"] = cs["tmr"] + 1
        return cs, bank


@pytest.mark.parametrize("toy,rule", [
    (_Diverging(), "handler-mismatch"), (_LaneWriter(), "lane-discipline")],
    ids=["handler-mismatch", "lane-discipline"])
def test_hook_disagreement_is_flagged(toy, rule):
    rep = check_protocol(toy, kill=False, configs=TINY)
    assert rule in _rules(rep), fail_fast([rep]) or "no findings"


# ---------------------------------------------------------------------------
# mutation checks: the reference's shipped-and-fixed bugs, re-seeded
# ---------------------------------------------------------------------------

class _WakeGrpAliasing(ColibriHier):
    """The aliasing bug: ``on_wake`` consumes ``wake_grp`` as a flat
    local-queue id without rebasing by ``bank * G``, so a wake on a bank
    other than bank 0 pops (and wakes from) ANOTHER bank's local queue."""
    name = "mutant_wake_grp_alias"

    def on_wake(self, ctx, cs, bank):
        G, _, cap_l = self._geom(ctx.p, ctx.n)
        wake_tmr = bank["wake_tmr"]
        wq = bank["wake_grp"]                # BUG: missing ba * G rebase
        lqbuf, lqhead, lqlen = bank["lqbuf"], bank["lqhead"], bank["lqlen"]
        fire = wake_tmr == 1
        wake_tmr = (wake_tmr - 1).clamp(min=0)
        valid = fire & (lqlen[wq] > 0)
        fire_core = lqbuf[wq, lqhead[wq]].masked_fill(~valid, ctx.n)
        woken = torch.zeros((ctx.n + 1,), dtype=torch.bool)
        woken[fire_core] = True
        woken = woken[:ctx.n]
        cs["st"] = cs["st"].masked_fill(woken, MOD)
        cs["tmr"] = torch.where(woken, ctx.mod_dur, cs["tmr"])
        popped = valid.to(torch.int32)
        lqhead = torch.remainder(lqhead.index_add(0, wq, popped), cap_l)
        lqlen = lqlen.index_add(0, wq, -popped)
        bank = dict(bank, wake_tmr=wake_tmr, lqhead=lqhead, lqlen=lqlen)
        return cs, bank, (wake_tmr == 1).sum(dtype=torch.int32)


def test_wake_grp_aliasing_mutant_is_caught():
    """Cross-bank aliasing needs >= 2 banks to exist at all — on the
    2-bank 2-group config the checker must refute the mutant."""
    rep = check_protocol(_WakeGrpAliasing(), kill=False,
                         configs=[Config(n=4, a=2, ops=1, n_groups=2)])
    assert not rep.ok
    assert _rules(rep) <= {"queue-conservation", "lost-wakeup",
                           "wake-corrupt", "double-grant", "deadlock",
                           "completion-unreachable"}, fail_fast([rep])


def test_single_bank_config_misses_the_aliasing_mutant():
    """On one bank the flat id and the group id coincide — the mutant
    is invisible, which is why configs_for pins a multi-bank config."""
    rep = check_protocol(_WakeGrpAliasing(), kill=False,
                         configs=[Config(n=3, a=1, ops=2, n_groups=2)])
    assert rep.ok
    assert any(c.a >= 2 for c in model_check.configs_for("colibri_hier"))


class _NoRecovery(LrscWait):
    name = "mutant_no_recovery"

    def on_timeout(self, ctx, cs, bank, stuck_b, killed, owner):
        return cs, bank, torch.zeros((ctx.a,), dtype=torch.int32)


def test_stale_owner_recovery_is_exercised():
    """The fault pass reaches watchdog evictions for the wait-class
    protocols; with recovery sabotaged the same scope deadlocks."""
    rep = check_protocol("lrscwait", kill=True,
                         configs=[Config(n=3, a=1, ops=1)])
    assert rep.ok, fail_fast([rep])
    bad = check_protocol(_NoRecovery(), kill=True,
                         configs=[Config(n=3, a=1, ops=1)])
    assert _rules(bad) == {"recovery-deadlock"}, fail_fast([bad])


def test_fused_side_is_one_seam():
    """Rebinding ``HookDriver.fused_side`` replaces the fused twin
    everywhere; a side that answers wrongly is a handler-mismatch."""
    seam = model_check.HookDriver.fused_side

    def wrong(kn, bank, fcore, win, acq_b, rel_b):
        bank2, kind, xset = seam(kn, bank, fcore, win, acq_b, rel_b)
        return bank2, kind * 0, xset
    model_check.HookDriver.fused_side = wrong
    try:
        rep = check_protocol("colibri", kill=False, configs=TINY)
    finally:
        model_check.HookDriver.fused_side = seam
    assert "handler-mismatch" in _rules(rep)
    assert check_protocol("colibri", kill=False, configs=TINY).ok


# ---------------------------------------------------------------------------
# trace checks: result keys, kernel instances, static axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("protocol", proto_names())
def test_trace_checks_pass_every_protocol(protocol):
    rep = trace_safety.audit_protocol(protocol)
    assert rep.ok, fail_fast([rep])
    keys = rep.stats["result_keys"]
    assert keys["telemetry"] == keys["base"] + 1
    assert keys["cluster2"] == keys["base"] + 1
    assert keys["trace"] == keys["base"] + 4


def test_static_fields_audit_passes():
    rep = trace_safety.audit_static_fields()
    assert rep.ok, fail_fast([rep])
    assert set(rep.stats["affecting"]) >= {"protocol", "workload",
                                           "n_cores", "topology", "faults",
                                           "record_trace",
                                           "telemetry_windows"}


def test_featureless_run_is_on_the_narrow_or_wide_instance():
    for name in proto_names():
        p = trace_safety.reference_params(name)
        code = proto_get(name).kernel_code
        want = (es_kernel.INSTANCE_WIDE if code in es_kernel.WIDE_FAMILIES
                else es_kernel.INSTANCE_NARROW)
        assert trace_safety._variant(p) == want, name
    assert trace_safety.expected_keys(trace_safety.reference_params(
        "colibri", faults={})) == trace_safety.expected_keys(
        trace_safety.reference_params("colibri"))


def test_carry_budget_drift_is_flagged(monkeypatch):
    monkeypatch.setattr(trace_safety, "ENGINE_KEYS",
                        trace_safety.ENGINE_KEYS[:-1])
    rep = trace_safety.audit_protocol("amo", quick=True)
    assert _rules(rep) == {"carry-count"}


def test_backend_parity_drift_is_flagged(monkeypatch):
    monkeypatch.setattr(es_kernel, "launch_variant",
                        lambda scalars: es_kernel.INSTANCE_PROG)
    rep = trace_safety.audit_protocol("lrsc", quick=True)
    assert _rules(rep) == {"backend-parity"}


def test_static_knob_drift_is_flagged(monkeypatch):
    monkeypatch.setattr(sweep, "STATIC_FIELDS", tuple(
        f for f in sweep.STATIC_FIELDS if f != "telemetry_windows"))
    rep = trace_safety.audit_static_fields()
    assert _rules(rep) == {"static-knob"}
    assert "telemetry_windows" in rep.findings[0].detail


def test_unobserved_field_is_flagged(monkeypatch):
    changes = dict(trace_safety.FIELD_CHANGES)
    del changes["seed"]
    monkeypatch.setattr(trace_safety, "FIELD_CHANGES", changes)
    rep = trace_safety.audit_static_fields()
    assert _rules(rep) == {"static-knob"}
    assert "'seed'" in rep.findings[0].detail


# ---------------------------------------------------------------------------
# integer-range analyzer: each theorem, and a seeded failure of each
# ---------------------------------------------------------------------------

def test_interval_arithmetic():
    iv = int_range.Interval
    assert (iv(1, 3) + iv(10, 20)) == iv(11, 23)
    assert (iv(-2, 3) * iv(5, 7)) == iv(-14, 21)
    assert iv(1, 4).shl(iv(0, 3)) == iv(1, 32)
    assert iv(0, 2**31 - 1).fits_int32()
    assert not iv(0, 2**31).fits_int32()
    assert iv(0, 2**63 - 1).fits_int64() and not iv(0, 2**63).fits_int64()
    with pytest.raises(ValueError):
        iv(5, 4)
    with pytest.raises(ValueError):
        iv(-1, 1).shl(iv(0, 1))


def test_range_pass_is_green():
    reps = int_range.check_all()
    assert all(r.ok for r in reps), fail_fast(reps)
    by = {r.subject: r for r in reps}
    assert by["level-count"].stats["max_admitted"] == 65_535
    assert by["arrival-sentinel"].stats["stamps"][1] == 2**31 - 2


def _bounds(monkeypatch, **kw):
    for k, v in kw.items():
        monkeypatch.setitem(int_range.ANALYSIS_BOUNDS, k, v)


def test_sentinel_tie_is_flagged(monkeypatch):
    _bounds(monkeypatch, cycles=(1, 2**31))
    assert _rules(int_range.check_sentinel()) == {"sentinel"}


def test_packed_key_carry_is_flagged(monkeypatch):
    _bounds(monkeypatch, n_cores=(1, 2**32 + 2))
    assert _rules(int_range.check_packed_key()) == {"packed-key"}


def test_packed_key_orders_lexicographically():
    n = 1000
    pairs = [(a, i) for a in (0, 1, 7, 2**31 - 1) for i in (0, 1, n - 1)]
    keys = [int_range.packed_key(a, i, 0, n) for a, i in pairs]
    assert keys == sorted(keys)
    assert int_range.packed_key(5, 3, n - 2, n) == (5 << 32) | 1


def test_level_count_limit_past_the_field_is_flagged(monkeypatch):
    monkeypatch.setattr(es_kernel, "MAX_TOPO_CORES", 1 << 17)
    rep = int_range.check_level_count()
    assert _rules(rep) == {"level-count"}
    assert "unsound" in fail_fast([rep])


def test_level_count_limit_below_the_field_is_flagged(monkeypatch):
    monkeypatch.setattr(es_kernel, "MAX_TOPO_CORES", 1 << 15)
    rep = int_range.check_level_count()
    assert "not tight" in fail_fast([rep])


def test_hash_without_the_split_overflows_int64(monkeypatch):
    assert int_range.check_hash().ok
    monkeypatch.setattr(int_range, "HASH_HALF_BITS", 0)
    rep = int_range.check_hash()
    assert _rules(rep) == {"hash-int64"}


def test_backoff_overflow_is_flagged(monkeypatch):
    _bounds(monkeypatch, backoff_exp=(1, 40))
    assert _rules(int_range.check_backoff()) == {"backoff-overflow"}


def test_backoff_bounded_in_envelope():
    iv = int_range.backoff_interval(2**20, 8)
    assert iv.fits_int32() and iv.lo == 0


def test_envelope_drift_is_flagged(monkeypatch):
    _bounds(monkeypatch, bogus_field=(0, 1))
    rep = int_range.check_envelope()
    assert _rules(rep) == {"envelope"}
    assert any("bogus_field" in f.detail for f in rep.findings)


# ---------------------------------------------------------------------------
# CLI and imports
# ---------------------------------------------------------------------------

def test_cli_green_run_with_json(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert analysis_main(["range", "trace", "--protocol", "amo", "--json",
                          str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["passes"] == ["range", "trace"]
    assert {r["pass"] for r in doc["reports"]} == {"range", "trace"}
    assert "OK:" in capsys.readouterr().out


def test_cli_exits_nonzero_on_findings(monkeypatch, capsys):
    bad = PassReport(pass_name="range", subject="seeded", findings=[
        Finding("range", "packed-key", "seeded", "seeded failure")])
    monkeypatch.setattr(int_range, "check_all", lambda quick=False: [bad])
    assert analysis_main(["range"]) == 1
    assert "packed-key" in capsys.readouterr().out


def test_unknown_pass_is_refused(capsys):
    with pytest.raises(ValueError, match="unknown pass"):
        run_passes(["modle"])
    with pytest.raises(SystemExit) as exc:
        analysis_main(["modle"])
    assert exc.value.code == 2


def test_package_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.__main__;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=dict(os.environ,
                                              PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
