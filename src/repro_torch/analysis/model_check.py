"""Protocol model checker: exhaustive small-scope exploration of the
plugin hooks against each protocol's declared :class:`Contract`.

The port of ``repro.analysis.model_check``, with the same rules, rule
names, configurations and state keys.  The engine drives protocols one
arbitration winner per bank per cycle, plus wake-timer fires and (under
fault plans) watchdog timeouts.  This checker drives the SAME hook
surface — ``on_access`` and its fused twin, ``on_wake``,
``held``/``on_timeout`` — over **every interleaving** of a tiny
configuration (2-4 cores, 1-2 banks, 1-2 ops per core), with the
engine's timing abstracted away: any pending request may be delivered
next, any pending wake may fire next.  Timing abstraction makes the
explored graph a superset of every real schedule, so a property that
holds here holds for all engine schedules of the small config.

Model per core: ``ACQ`` (acquire in flight) -> ``HOLD`` (granted,
release in flight) -> back to ``ACQ`` (ops left) or ``DONE``; a parked
core is ``SLEEP`` until a wake hands it ownership; the fault pass adds
``DEAD``.  Ghost state the checker tracks independently of the
protocol: per-bank owner, per-core ops-left.  Wake timers are
normalized to pending flags (the model fires a pending wake by setting
its bank's timer to 1 and every other pending bank's to 2, so one
``on_wake`` call fires exactly the chosen bank).

The hooks run eagerly on CPU tensors under ``torch.inference_mode()``;
states are numpy dicts, and each distinct hook call is made once (the
fault pass re-reaches most of the normal pass's states).  The fused
twin is :attr:`HookDriver.fused_side`, ``fused_access`` by default; a
run on the card rebinds it to the ``engine_step`` kernel
(:func:`stepped`), which then stands in for ``fused_access`` on every
reachable state.

Checked rules (rule ids as reported):

==========================  ============================================
``handler-mismatch``        the fused side disagrees with ``on_access``
                            (bank state, per-core protocol state, or the
                            outcome code derived from the core writes)
``lane-discipline``         ``on_access`` wrote a non-winner core's state
``double-grant``            grant/wake while the bank has an owner
                            (``exclusive_grant``)
``foreign-release``         a release completed for a non-owner
``phantom-outcome``         no outcome for a delivered winner, or an
                            outcome illegal for the phase
``retry-free``              ``OUT_FAIL`` from a ``retry_free`` protocol
``fail-not-full``           ``OUT_FAIL`` with queue slots free
                            (``fail_requires_full``)
``unexpected-sleep``        ``OUT_SLEEP`` from a non-``wait_class``
                            protocol
``wake-corrupt``            a wake hit a core that was neither sleeping
                            nor the bank's owner
``queue-conservation``      ``queue_depth`` != sleepers (+ holder when
                            ``queue_counts_holder``)
``lost-wakeup``             terminal state with a live core asleep
``deadlock``                terminal state with live undone cores awake
``completion-unreachable``  a reachable state with NO path to all-done
``live-evict``              ``on_timeout`` evicted with every core live
                            (without ``evict_live_safe``)
``recovery-deadlock``       after a holder death, live cores cannot all
                            finish even with the watchdog
==========================  ============================================

The fault pass (``kill=True``) additionally branches a holder death at
every ownership acquisition and enables the watchdog event on held
banks with no live in-flight owner — the small-scope version of the
stale-owner scenario.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.report import Finding, PassReport
from repro_torch.core import protocols as proto_registry
from repro_torch.core.protocols.base import (MOD, NXT_BACKOFF, NXT_MOD,
                                             NXT_WORK_DONE, OUT_DONE,
                                             OUT_EVICT, OUT_FAIL, OUT_GRANT,
                                             OUT_NONE, OUT_SLEEP, P_ACQ,
                                             P_REL, REQ, RESP, SLEEP, WORK,
                                             Ctx, FusedCtx)

# model core modes
M_ACQ, M_HOLD, M_SLEEP, M_DONE, M_DEAD = 0, 1, 2, 3, 4
_MODE_CH = "AHSDX"

#: exploration safety valve — the tiny configs stay well under this
MAX_STATES = 250_000

#: the arbitration's "no request" stamp (``kernels/engine_step/ref.py``)
_BIG = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Config:
    """One small-scope configuration: ``wa`` maps core -> home bank."""
    n: int
    a: int = 1
    ops: int = 2
    q_slots: int = 64
    n_groups: int = 2
    topology: str = "flat"
    clusters: int = 2

    @property
    def wa(self) -> Tuple[int, ...]:
        return tuple(c % self.a for c in range(self.n))

    def label(self) -> str:
        lbl = (f"n={self.n} a={self.a} ops={self.ops} q={self.q_slots}"
               f" g={self.n_groups}")
        if self.topology != "flat":
            lbl += f" topo={self.topology}/{self.clusters}"
        return lbl


@dataclasses.dataclass(frozen=True)
class _P:
    """Static parameter namespace handed to the hooks (the model has no
    clock, so the latency knobs only have to be positive; topology-aware
    protocols like ``hw_event`` size their cluster queues from
    ``topology``/``clusters``; ``n_cores`` is the config's core count,
    which the kernel's two-level branch is sized by)."""
    n_cores: int
    q_slots: int
    n_groups: int
    topology: str
    clusters: int
    lat: int = 1
    work: int = 1
    modify: int = 1

    @classmethod
    def of(cls, cfg: Config) -> "_P":
        return cls(n_cores=cfg.n, q_slots=cfg.q_slots,
                   n_groups=cfg.n_groups, topology=cfg.topology,
                   clusters=cfg.clusters)


def configs_for(name: str, quick: bool = False) -> List[Config]:
    """Small-scope grid per protocol.  ``lrscwait`` adds a q=1 config
    (the finite-queue FAIL path); ``colibri_hier`` adds a 4-core
    2-bank 2-group config (cross-bank queue aliasing is invisible with
    a single bank).  ``hw_event`` runs 2-cluster ``cluster2`` configs
    where every bank is shared across clusters, so a cross-cluster
    wakeup delivered to the wrong cluster queue (or a per-cluster queue
    aliased across banks) reaches a checked state; ``nb_feb`` adds the
    same 2-cluster shape to certify the FEB invariant is
    topology-independent."""
    if name == "colibri_hier":
        cfgs = [Config(n=3, a=1, ops=2, n_groups=2),
                Config(n=4, a=2, ops=1, n_groups=2)]
        return cfgs[:1] if quick else cfgs
    if name == "hw_event":
        # block placement puts cores {0,1} / {2,3} in clusters 0 / 1;
        # with wa = c % a every bank then serves both clusters, so the
        # cross-cluster handoff and the intra-cluster wakeup broadcast
        # both fire, and the a=2 config additionally interleaves two
        # banks' per-cluster queues (the aliasing scope)
        cfgs = [Config(n=3, a=1, ops=2, n_groups=2),
                Config(n=4, a=1, ops=1, topology="cluster2", clusters=2),
                Config(n=4, a=2, ops=1, topology="cluster2", clusters=2)]
        return cfgs[:1] if quick else cfgs
    base = [Config(n=2, a=1, ops=2), Config(n=3, a=1, ops=2),
            Config(n=3, a=2, ops=1)]
    if name == "lrscwait":
        base.insert(1, Config(n=2, a=1, ops=2, q_slots=1))
        return [base[0], base[1]] if quick else base
    if name == "nb_feb":
        base.append(Config(n=4, a=2, ops=1, topology="cluster2",
                           clusters=2))
        return base[:1] if quick else base
    return base[:1] if quick else base


@dataclasses.dataclass
class _State:
    modes: Tuple[int, ...]
    ops: Tuple[int, ...]
    owner: Tuple[int, ...]           # per bank; -1 = none
    bank: Dict[str, np.ndarray]
    xc: Dict[str, np.ndarray]

    def key(self) -> bytes:
        parts = [bytes(self.modes), bytes(o % 256 for o in self.ops),
                 bytes((o + 1) % 256 for o in self.owner)]
        for k in sorted(self.bank):
            parts.append(self.bank[k].tobytes())
        for k in sorted(self.xc):
            parts.append(self.xc[k].tobytes())
        return b"|".join(parts)

    def label(self) -> str:
        return ("cores=" + "".join(_MODE_CH[m] for m in self.modes)
                + " ops=" + "".join(str(o) for o in self.ops)
                + " owner=" + ",".join(str(o) for o in self.owner))


def _normalize(bank: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Wake timers carry delays in the engine; the model only cares
    whether a wake is pending."""
    if "wake_tmr" in bank:
        bank = dict(bank)
        bank["wake_tmr"] = (bank["wake_tmr"] > 0).astype(np.int32)
    return bank


def _t(d: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """CPU tensors of a numpy dict (copies: a hook may write in place)."""
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


def _np(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in d.items()}


def _bytes(d: Dict[str, np.ndarray]) -> bytes:
    return b"|".join(d[k].tobytes() for k in sorted(d))


class HookDriver:
    """The hooks of one (protocol, config) pair, called eagerly on CPU
    tensors; every distinct call is made once and remembered."""

    def __init__(self, proto, cfg: Config):
        self.proto, self.cfg = proto, cfg
        n, a = cfg.n, cfg.a
        self.p = p = _P.of(cfg)
        self.q_cap = q_cap = proto.q_cap(p, n)
        i32 = torch.int32
        self._wa = torch.tensor(cfg.wa, dtype=i32)
        self._wc = torch.arange(n, dtype=i32)
        self._ba = torch.arange(a, dtype=i32)
        self._ones = torch.ones((n,), dtype=i32)
        self._memo: Dict[tuple, Any] = {}
        with torch.inference_mode():
            self.init_bank = _normalize(_np(proto.init_bank_state(
                p, a, n, q_cap, "cpu")))
            self.init_xc = _np(proto.init_core_state(p, n, "cpu"))
            self.has_held = proto.held(_t(self.init_bank)) is not None
        self.xc_keys = tuple(self.init_xc)
        self.has_wake = "wake_tmr" in self.init_bank

    def _ctx(self, is_acq=None, is_rel=None, win=None, acq_b=None,
             rel_b=None) -> Ctx:
        n, a = self.cfg.n, self.cfg.a
        zn, za = torch.zeros((n,), dtype=torch.bool), \
            torch.zeros((a,), dtype=torch.bool)
        return Ctx(p=self.p, n=n, a=a, q_cap=self.q_cap,
                   is_acq=zn if is_acq is None else is_acq,
                   is_rel=zn if is_rel is None else is_rel,
                   wa=self._wa, wc=self._wc, ba=self._ba,
                   win_core=(torch.full((a,), n, dtype=torch.int32)
                             if win is None else win),
                   acq_b=za if acq_b is None else acq_b,
                   rel_b=za if rel_b is None else rel_b,
                   mod_dur=self._ones)

    def _cs(self, st: np.ndarray, xc: Dict[str, np.ndarray]) -> Dict:
        n = self.cfg.n
        cs = dict(st=torch.from_numpy(st.astype(np.int32)),
                  tmr=torch.zeros((n,), dtype=torch.int32),
                  nxt=torch.full((n,), -1, dtype=torch.int32),
                  polls=torch.zeros((), dtype=torch.int32),
                  msgs=torch.zeros((), dtype=torch.int32))
        cs.update(_t(xc))
        return cs

    def _once(self, key: tuple, fn):
        hit = self._memo.get(key)
        if hit is None:
            with torch.inference_mode():
                hit = self._memo[key] = fn()
        return hit

    # ---- the fused twin: the seam ----------------------------------------
    def fused_side(self, bank: Dict[str, np.ndarray],
                   fcore: Dict[str, np.ndarray], win: np.ndarray,
                   acq_b: np.ndarray, rel_b: np.ndarray):
        """The bank side of one delivery, ``(bank, kind, xset)`` as numpy:
        ``fused_access`` on the pre-state (``fcore`` holds the
        ``fused_core_fields`` gathered at each bank's winner)."""
        bank2, fo = self.proto.fused_access(
            FusedCtx(p=self.p, n=self.cfg.n, a=self.cfg.a, q_cap=self.q_cap,
                     win=torch.from_numpy(win), acq_b=torch.from_numpy(acq_b),
                     rel_b=torch.from_numpy(rel_b), core=_t(fcore)),
            _t(bank))
        return (_np(bank2), fo.kind.numpy(),
                {k: (v.numpy(), m.numpy()) for k, (v, m) in fo.xset.items()})

    # ---- transitions -----------------------------------------------------
    def deliver(self, bank, xc, st, c: int, phase: int):
        return self._once(("deliver", c, phase, _bytes(bank), _bytes(xc),
                           st.tobytes()),
                          lambda: self._deliver(bank, xc, st, c, phase))

    def _deliver(self, bank, xc, st, c, phase):
        n, a = self.cfg.n, self.cfg.a
        b = self.cfg.wa[c]
        onehot = np.arange(n) == c
        acq = phase == P_ACQ
        win = np.full((a,), n, np.int32)
        win[b] = c
        hit = np.arange(a) == b
        acq_b, rel_b = hit & acq, hit & (not acq)
        st_in = np.where(onehot, REQ, st).astype(np.int32)
        cs = self._cs(st_in, xc)
        cs2, bank2 = self.proto.on_access(
            self._ctx(torch.from_numpy(onehot & acq),
                      torch.from_numpy(onehot & (not acq)),
                      torch.from_numpy(win), torch.from_numpy(acq_b),
                      torch.from_numpy(rel_b)),
            dict(cs), _t(bank))
        cs2, bank2 = _np(cs2), _np(bank2)
        stc, nxtc = cs2["st"][c], cs2["nxt"][c]
        out = (OUT_SLEEP if stc == SLEEP
               else OUT_GRANT if stc == RESP and nxtc == NXT_MOD
               else OUT_DONE if stc == RESP and nxtc == NXT_WORK_DONE
               else OUT_FAIL if stc == RESP and nxtc == NXT_BACKOFF
               else OUT_NONE)
        off = ~onehot
        touched = bool((off & (cs2["st"] != st_in)).any()
                       | (off & (cs2["nxt"] != -1)).any()
                       | (off & (cs2["tmr"] != 0)).any())
        for k in self.xc_keys:
            touched |= bool((off & (cs2[k] != xc[k])).any())
        # the fused twin on the same pre-state
        wcs = np.minimum(win, n - 1)
        bank3, kind, xset = self.fused_side(
            bank, {k: xc[k][wcs] for k in self.proto.fused_core_fields},
            win, acq_b, rel_b)
        xc3 = {k: v.copy() for k, v in xc.items()}
        for k, (vals, msk) in xset.items():
            sel = msk & (win < n)
            xc3[k][win[sel]] = vals[sel]
        agree = (set(bank3) == set(bank2)
                 and all(np.array_equal(bank2[k], bank3[k]) for k in bank2)
                 and all(np.array_equal(cs2[k], xc3[k])
                         for k in self.xc_keys)
                 and out == int(kind[b]))
        xc2 = {k: cs2[k] for k in self.xc_keys}
        return bank2, xc2, out, int(kind[b]), agree, touched

    def wake(self, bank, xc, st, b: int):
        return self._once(("wake", b, _bytes(bank), _bytes(xc),
                           st.tobytes()),
                          lambda: self._wake(bank, xc, st, b))

    def _wake(self, bank, xc, st, b):
        pend = bank["wake_tmr"] > 0
        bank_in = dict(bank, wake_tmr=np.where(
            np.arange(self.cfg.a) == b, 1, np.where(pend, 2, 0)
        ).astype(np.int32))
        cs2, bank2, _ = self.proto.on_wake(self._ctx(), self._cs(st, xc),
                                           _t(bank_in))
        woken = cs2["st"].numpy() == MOD
        return _np(bank2), {k: cs2[k].numpy() for k in self.xc_keys}, woken

    def timeout(self, bank, xc, st, stuck_b, killed, owner_arr):
        return self._once(("timeout", _bytes(bank), _bytes(xc),
                           st.tobytes(), stuck_b.tobytes(),
                           killed.tobytes(), owner_arr.tobytes()),
                          lambda: self._timeout(bank, xc, st, stuck_b,
                                                killed, owner_arr))

    def _timeout(self, bank, xc, st, stuck_b, killed, owner_arr):
        cs2, bank2, kind = self.proto.on_timeout(
            self._ctx(), self._cs(st, xc), _t(bank),
            torch.from_numpy(stuck_b), torch.from_numpy(killed),
            torch.from_numpy(owner_arr))
        return (_np(bank2), {k: cs2[k].numpy() for k in self.xc_keys},
                kind.numpy())

    def held_np(self, bank) -> np.ndarray:
        return self._once(("held", _bytes(bank)),
                          lambda: self.proto.held(_t(bank)).numpy())

    def qdepth_np(self, bank) -> Optional[np.ndarray]:
        def depth():
            qd = self.proto.queue_depth(_t(bank))
            return None if qd is None else qd.numpy()
        return self._once(("qdepth", _bytes(bank)), depth)


def stepped(step, device):
    """A :attr:`HookDriver.fused_side` that runs ``step`` — a callable of
    ``kernels.engine_step.fused_step``'s signature — on ``device`` for
    each delivery: the one-candidate step (``cand_cyc`` ``_BIG`` on every
    lane but the delivered core's, the rotation the identity), the bank
    state copied in, its bank state, kinds and per-core writes copied
    back.  A bank whose step winner differs from the delivered one
    answers kind -1, which no outcome equals."""
    dev = torch.device(device)

    def fused_side(kn, bank, fcore, win, acq_b, rel_b):
        n, a = kn.cfg.n, kn.cfg.a
        b = int(np.flatnonzero(win < n)[0])
        c = int(win[b])
        i32 = np.int32
        cand = np.full((n,), _BIG, i32)
        cand[c] = 0
        addr, phase = np.zeros((n,), i32), np.zeros((n,), i32)
        addr[c], phase[c] = b, P_ACQ if acq_b[b] else P_REL
        core = {}
        for k, v in fcore.items():
            core[k] = np.full((n,), -1, i32)
            core[k][c] = v[b]

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        out = step(kn.proto, kn.p, {k: t(v.copy()) for k, v in bank.items()},
                   cand_cyc=t(cand), rot=t(np.arange(n, dtype=i32)),
                   addr=t(addr), phase=t(phase),
                   acq_start=t(np.zeros((n,), i32)),
                   core={k: t(v) for k, v in core.items()}, cyc=0, shift=0,
                   lat=kn.p.lat, n=n, a=a, q_cap=kn.q_cap, cycles=1)
        kind = out["kind"].cpu().numpy()
        kind = np.where(out["win"].cpu().numpy() == win, kind, -1)
        return ({k: v.cpu().numpy() for k, v in out["bank"].items()}, kind,
                {k: (v.cpu().numpy(), m.cpu().numpy())
                 for k, (v, m) in out["xset"].items()})
    return fused_side


def _st_in(modes: Tuple[int, ...]) -> np.ndarray:
    return np.asarray([SLEEP if m == M_SLEEP else WORK for m in modes],
                      np.int32)


class _Explorer:
    """BFS over the interleaving graph of one (protocol, config)."""

    def __init__(self, proto, cfg: Config, kill: bool,
                 kernels: Optional[HookDriver] = None):
        self.proto, self.cfg, self.kill = proto, cfg, kill
        self.kn = kernels or HookDriver(proto, cfg)
        self.contract = proto.contract
        self.findings: Dict[str, Finding] = {}
        self.counts: Dict[str, int] = {}
        self.transitions = 0
        self._probed: set = set()

    # ---- findings --------------------------------------------------------
    def _flag(self, rule: str, detail: str, state: _State) -> None:
        self.counts[rule] = self.counts.get(rule, 0) + 1
        if rule not in self.findings:
            mode = "fault pass" if self.kill else "normal pass"
            self.findings[rule] = Finding(
                pass_name="model", rule=rule, subject=self.proto.name,
                detail=detail,
                where=f"{self.cfg.label()} ({mode}) at {state.label()}")

    # ---- invariants ------------------------------------------------------
    def _check_state(self, s: _State) -> None:
        qd = self.kn.qdepth_np(s.bank)
        if qd is not None:
            for b in range(self.cfg.a):
                exp = sum(1 for c in range(self.cfg.n)
                          if s.modes[c] == M_SLEEP and self.cfg.wa[c] == b)
                if self.contract.queue_counts_holder and s.owner[b] >= 0:
                    exp += 1
                if int(qd[b]) != exp:
                    self._flag("queue-conservation",
                               f"bank {b}: queue_depth={int(qd[b])} but "
                               f"{exp} cores are accounted for (sleepers"
                               + (" + holder" if
                                  self.contract.queue_counts_holder else "")
                               + ")", s)
        # live-owner watchdog probe (non-mutating, deduped by bank state)
        if self.kn.has_held and not self.contract.evict_live_safe:
            bkey = _bytes(s.bank)
            if bkey not in self._probed:
                self._probed.add(bkey)
                held = self.kn.held_np(s.bank)
                if held.any():
                    owner_arr = np.asarray(
                        [o if o >= 0 else self.cfg.n for o in s.owner],
                        np.int32)
                    _, _, kind = self.kn.timeout(
                        s.bank, s.xc, _st_in(s.modes), held,
                        np.zeros((self.cfg.n,), bool), owner_arr)
                    if (kind == OUT_EVICT).any():
                        self._flag(
                            "live-evict",
                            "on_timeout returned OUT_EVICT with every core "
                            "alive — the watchdog would evict a live owner "
                            "(declare evict_live_safe only if that is safe "
                            "by construction, like lrsc slot expiry)", s)

    # ---- transitions -----------------------------------------------------
    def _apply_deliver(self, s: _State, c: int, phase: int
                       ) -> Optional[_State]:
        kn, cfg, ct = self.kn, self.cfg, self.contract
        b = cfg.wa[c]
        bank2, xc2, out, kind, agree, touched = kn.deliver(
            s.bank, s.xc, _st_in(s.modes), c, phase)
        if not agree:
            self._flag("handler-mismatch",
                       f"core {c} phase {'acq' if phase == P_ACQ else 'rel'}"
                       f": on_access outcome {out} / fused kind "
                       f"{kind} or diverging state", s)
        if touched:
            self._flag("lane-discipline",
                       f"on_access for winner {c} wrote another core's "
                       f"state", s)
        modes, ops, owner = list(s.modes), list(s.ops), list(s.owner)
        if out == OUT_NONE:
            self._flag("phantom-outcome",
                       f"delivered winner {c} got no outcome", s)
            return None
        if phase == P_ACQ:
            if out == OUT_GRANT:
                if ct.exclusive_grant and owner[b] >= 0:
                    self._flag("double-grant",
                               f"core {c} granted bank {b} while core "
                               f"{owner[b]} still owns it", s)
                owner[b] = c
                modes[c] = M_HOLD
            elif out == OUT_DONE:       # single-access commit (amo)
                if ct.exclusive_grant and owner[b] >= 0:
                    self._flag("double-grant",
                               f"core {c} committed at bank {b} while core "
                               f"{owner[b]} owns it", s)
                ops[c] -= 1
                modes[c] = M_ACQ if ops[c] > 0 else M_DONE
            elif out == OUT_SLEEP:
                if not ct.wait_class:
                    self._flag("unexpected-sleep",
                               f"non-wait protocol parked core {c}", s)
                modes[c] = M_SLEEP
            elif out == OUT_FAIL:
                if ct.retry_free:
                    self._flag("retry-free",
                               f"retry-free protocol failed core {c}'s "
                               f"acquire (a poll)", s)
                elif ct.fail_requires_full:
                    occupied = sum(
                        1 for k in range(cfg.n)
                        if s.modes[k] == M_SLEEP and cfg.wa[k] == b)
                    if ct.queue_counts_holder and s.owner[b] >= 0:
                        occupied += 1
                    if occupied < kn.q_cap:
                        self._flag(
                            "fail-not-full",
                            f"core {c} rejected at bank {b} with only "
                            f"{occupied}/{kn.q_cap} queue slots used", s)
                # retry: the model redelivers later
            else:
                self._flag("phantom-outcome",
                           f"acquire outcome {out} for core {c}", s)
        else:
            if out == OUT_DONE:
                if ct.exclusive_grant and owner[b] != c:
                    self._flag("foreign-release",
                               f"core {c} completed a release on bank {b} "
                               f"owned by {owner[b]}", s)
                if owner[b] == c:
                    owner[b] = -1
                ops[c] -= 1
                modes[c] = M_ACQ if ops[c] > 0 else M_DONE
            elif out == OUT_FAIL:        # failed SC: full retry
                if ct.retry_free:
                    self._flag("retry-free",
                               f"retry-free protocol failed core {c}'s "
                               f"release", s)
                modes[c] = M_ACQ
            else:
                self._flag("phantom-outcome",
                           f"release outcome {out} for core {c}", s)
        return _State(tuple(modes), tuple(ops), tuple(owner),
                      _normalize(bank2), xc2)

    def _apply_wake(self, s: _State, b: int) -> Optional[_State]:
        cfg, ct = self.cfg, self.contract
        bank2, xc2, woken = self.kn.wake(s.bank, s.xc, _st_in(s.modes), b)
        modes, ops, owner = list(s.modes), list(s.ops), list(s.owner)
        for c in np.nonzero(woken)[0]:
            c = int(c)
            wb = cfg.wa[c]
            if s.modes[c] == M_SLEEP:
                if ct.exclusive_grant and owner[wb] >= 0:
                    self._flag("double-grant",
                               f"wake handed bank {wb} to core {c} while "
                               f"core {owner[wb]} owns it", s)
                owner[wb] = c
                modes[c] = M_HOLD
            elif s.owner[wb] == c:
                pass                     # redelivered wake to the owner
            elif s.modes[c] == M_DEAD:
                owner[wb] = c            # wake reached a dead sleeper
            else:
                self._flag("wake-corrupt",
                           f"wake of bank {b} hit core {c} "
                           f"({_MODE_CH[s.modes[c]]}) which was neither "
                           f"asleep nor bank {wb}'s owner", s)
        return _State(tuple(modes), tuple(ops), tuple(owner),
                      _normalize(bank2), xc2)

    def _apply_watchdog(self, s: _State, b: int) -> Optional[_State]:
        cfg = self.cfg
        killed = np.asarray([m == M_DEAD for m in s.modes], bool)
        owner_arr = np.asarray([o if o >= 0 else cfg.n for o in s.owner],
                               np.int32)
        stuck = np.zeros((cfg.a,), bool)
        stuck[b] = True
        bank2, xc2, kind = self.kn.timeout(
            s.bank, s.xc, _st_in(s.modes), stuck, killed, owner_arr)
        modes, ops, owner = list(s.modes), list(s.ops), list(s.owner)
        if int(kind[b]) == OUT_EVICT:
            # for evict_live_safe protocols (lrsc slot expiry) the ghost
            # owner is the last grantee, not the resource holder, so the
            # live-owner attribution below would be unsound
            if (not self.contract.evict_live_safe
                    and owner[b] >= 0 and s.modes[owner[b]] != M_DEAD):
                self._flag("live-evict",
                           f"watchdog evicted bank {b}'s live owner "
                           f"{owner[b]}", s)
            owner[b] = -1
        return _State(tuple(modes), tuple(ops), tuple(owner),
                      _normalize(bank2), xc2)

    # ---- events ----------------------------------------------------------
    def _events(self, s: _State) -> List[Tuple]:
        evs: List[Tuple] = []
        for c in range(self.cfg.n):
            if s.modes[c] == M_ACQ:
                evs.append(("deliver", c, P_ACQ))
            elif s.modes[c] == M_HOLD:
                evs.append(("deliver", c, P_REL))
        if self.kn.has_wake:
            for b in np.nonzero(s.bank["wake_tmr"] > 0)[0]:
                evs.append(("wake", int(b)))
        if self.kill:
            died = any(m == M_DEAD for m in s.modes)
            if not died:
                for c in range(self.cfg.n):
                    if s.modes[c] == M_HOLD:
                        evs.append(("die", c))
            elif self.kn.has_held:
                held = self.kn.held_np(s.bank)
                for b in range(self.cfg.a):
                    if not held[b]:
                        continue
                    live_inflight = any(
                        s.modes[c] == M_HOLD and self.cfg.wa[c] == b
                        for c in range(self.cfg.n))
                    if not live_inflight:
                        evs.append(("watchdog", b))
        return evs

    def _apply(self, s: _State, ev: Tuple) -> Optional[_State]:
        if ev[0] == "deliver":
            return self._apply_deliver(s, ev[1], ev[2])
        if ev[0] == "wake":
            return self._apply_wake(s, ev[1])
        if ev[0] == "die":
            modes = list(s.modes)
            modes[ev[1]] = M_DEAD
            return _State(tuple(modes), s.ops, s.owner, s.bank, s.xc)
        return self._apply_watchdog(s, ev[1])

    # ---- main loop -------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        init = _State(tuple([M_ACQ] * self.cfg.n),
                      tuple([self.cfg.ops] * self.cfg.n),
                      tuple([-1] * self.cfg.a),
                      dict(self.kn.init_bank), dict(self.kn.init_xc))
        seen: Dict[bytes, _State] = {init.key(): init}
        succs: Dict[bytes, List[bytes]] = {}
        frontier = deque([init.key()])
        self._check_state(init)
        while frontier and not self.findings:
            k = frontier.popleft()
            s = seen[k]
            out: List[bytes] = []
            for ev in self._events(s):
                self.transitions += 1
                s2 = self._apply(s, ev)
                if s2 is None:
                    continue
                k2 = s2.key()
                if k2 == k:
                    continue
                out.append(k2)
                if k2 not in seen:
                    if len(seen) >= MAX_STATES:
                        raise RuntimeError(
                            f"{self.proto.name}/{self.cfg.label()}: state "
                            f"space exceeded {MAX_STATES}")
                    seen[k2] = s2
                    self._check_state(s2)
                    frontier.append(k2)
            succs[k] = out
            if not out and not self._all_done(s):
                asleep = [c for c in range(self.cfg.n)
                          if s.modes[c] == M_SLEEP]
                rule = ("recovery-deadlock" if self.kill and
                        any(m == M_DEAD for m in s.modes)
                        else "lost-wakeup" if asleep else "deadlock")
                self._flag(rule,
                           "terminal state with live unfinished cores"
                           + (f" (cores {asleep} asleep, no wake pending)"
                              if asleep else ""), s)
        if not self.findings:
            self._reverse_check(seen, succs)
        return dict(states=len(seen), transitions=self.transitions,
                    findings=list(self.findings.values()),
                    counts=dict(self.counts))

    def _all_done(self, s: _State) -> bool:
        return all(m in (M_DONE, M_DEAD) for m in s.modes)

    def _reverse_check(self, seen, succs) -> None:
        """Every reachable state must have SOME path on which all live
        cores finish — the liveness half of no-lost-wakeup / recovery."""
        rev: Dict[bytes, List[bytes]] = {k: [] for k in seen}
        for k, outs in succs.items():
            for k2 in outs:
                rev[k2].append(k)
        good = deque(k for k, s in seen.items() if self._all_done(s))
        ok = set(good)
        while good:
            for pk in rev[good.popleft()]:
                if pk not in ok:
                    ok.add(pk)
                    good.append(pk)
        bad = [k for k in seen if k not in ok]
        if bad:
            rule = "recovery-deadlock" if self.kill \
                else "completion-unreachable"
            self._flag(rule,
                       f"{len(bad)} of {len(seen)} reachable states have "
                       f"no path to completion", seen[bad[0]])


def check_protocol(proto, quick: bool = False, kill: bool = True,
                   configs: Optional[List[Config]] = None) -> PassReport:
    """Model-check one protocol (a registered name or a ``Protocol``
    instance) over its small-scope configs; the fault pass runs too
    unless ``kill=False`` or the protocol has no held state.  The report's
    stats add ``per_config``: states and transitions of each config (both
    passes), in order."""
    if isinstance(proto, str):
        proto = proto_registry.get(proto)
    rep = PassReport(pass_name="model", subject=proto.name)
    t0 = time.perf_counter()
    states = transitions = 0
    counts: Dict[str, int] = {}
    per_config = []
    for cfg in (configs if configs is not None
                else configs_for(proto.name, quick)):
        kn = HookDriver(proto, cfg)
        passes = [False] + ([True] if kill and kn.has_held else [])
        cfg_states = cfg_transitions = 0
        for kmode in passes:
            r = _Explorer(proto, cfg, kmode, kernels=kn).run()
            cfg_states += r["states"]
            cfg_transitions += r["transitions"]
            rep.findings.extend(r["findings"])
            for rule, cnt in r["counts"].items():
                counts[rule] = counts.get(rule, 0) + cnt
        states += cfg_states
        transitions += cfg_transitions
        per_config.append(dict(config=cfg.label(), states=cfg_states,
                               transitions=cfg_transitions))
    rep.stats = dict(states=states, transitions=transitions,
                     violation_counts=counts, per_config=per_config)
    rep.wall_s = time.perf_counter() - t0
    return rep


def check_all(quick: bool = False, kill: bool = True,
              protocols: Optional[List[str]] = None) -> List[PassReport]:
    names = protocols or proto_registry.names()
    return [check_protocol(nm, quick=quick, kill=kill) for nm in names]
