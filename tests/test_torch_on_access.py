"""The port's masked ``on_access`` against the reference's, bit for bit.

For each of the eleven protocols (and colibri_hier at 3 groups, hw_event
on cluster2 and at 3 units, lrscwait with 2 queue slots) seeded numpy
states — bank states from ``chip_smoke.random_bank`` (full queues, held
locks and reservations, pending wakes, the two-level queues in the shape
the protocols reach) and random per-core lanes and counters — get one
delivery per bank (a random core of that bank, acquire or release, some
banks without a winner) through the reference's ``on_access`` (jitted,
CPU) and the port's.  Every bank key, core key and counter must be
equal, dtypes included.  Then, on the same pre-state, the port's
``on_access`` must equal its own ``fused_access`` plus the engine's
outcome apply (the model checker's ``handler-mismatch`` clause: bank
state, outcome code, timer, per-core writes, polls and side messages),
and must not write a non-winner core (``lane-discipline``).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocols as jprotocols
from repro.core.protocols.base import Ctx as JCtx
from repro.core.sim import SimParams as JParams
from repro_torch import convert
from repro_torch.core import protocols as tprotocols
from repro_torch.core.protocols.base import (NXT_BACKOFF, NXT_MOD,
                                             NXT_WORK_DONE, OUT_DONE,
                                             OUT_FAIL, OUT_GRANT, OUT_NONE,
                                             OUT_SLEEP, REQ, RESP, SLEEP,
                                             Ctx, FusedCtx)
from repro_torch.core.sim import SimParams as TParams
from jax_cache import release_compiled  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PROTOS = ("amo", "lrsc", "lrscwait", "colibri", "amo_lock", "lrsc_lock",
          "ticket_lock", "mwait_lock", "colibri_hier", "hw_event", "nb_feb")
#: (protocol, SimParams fields): every protocol at two shapes, and the
#: geometries where the two-level queues and the finite queue differ
CASES = ([(pr, dict(n_cores=8, n_addrs=2)) for pr in PROTOS]
         + [(pr, dict(n_cores=16, n_addrs=4)) for pr in PROTOS]
         + [("lrscwait", dict(n_cores=8, n_addrs=2, q_slots=2)),
            ("colibri_hier", dict(n_cores=10, n_addrs=3, n_groups=3)),
            ("hw_event", dict(n_cores=8, n_addrs=2, topology="cluster2",
                              clusters=2)),
            ("hw_event", dict(n_cores=10, n_addrs=3, n_groups=3))])
#: seeded states per case
STATES = 8


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_random_bank = _chip_smoke().random_bank


def _random_state(proto, p, n, a, q_cap, rng):
    """A bank state, the core lanes and one delivery per bank."""
    bank = _random_bank(proto, p, a, n, q_cap, rng)
    wa = rng.integers(0, a, n).astype(np.int32)
    win = np.full((a,), n, np.int32)
    acq_b, rel_b = np.zeros(a, bool), np.zeros(a, bool)
    for b in range(a):
        mine = np.flatnonzero(wa == b)
        if len(mine) and rng.random() < 0.85:
            win[b] = rng.choice(mine)
            (acq_b if rng.random() < 0.5 else rel_b)[b] = True
    is_acq, is_rel = np.zeros(n, bool), np.zeros(n, bool)
    is_acq[win[acq_b]] = True
    is_rel[win[rel_b]] = True
    st = rng.integers(0, 7, n).astype(np.int32)
    st[win[win < n]] = REQ
    cs = dict(st=st, tmr=rng.integers(0, 9, n).astype(np.int32),
              nxt=rng.integers(-1, 3, n).astype(np.int32),
              polls=np.int32(rng.integers(0, 50)),
              msgs=np.int32(rng.integers(0, 50)))
    cs = {k: np.asarray(v, np.int32) for k, v in cs.items()}
    for k in proto.init_core_state(p, n, "cpu"):
        cs[k] = rng.integers(-1, 8, n).astype(np.int32)
    lanes = dict(is_acq=is_acq, is_rel=is_rel, wa=wa, win_core=win,
                 acq_b=acq_b, rel_b=rel_b)
    return bank, cs, lanes


def _reference(name, fields, n, a, q_cap):
    jp = JParams(protocol=name, backend="xla_cpu", **fields)
    jproto = jprotocols.get(name)

    @jax.jit
    def f(cs, bank, lanes):
        ctx = JCtx(p=jp, n=n, a=a, q_cap=q_cap,
                   wc=jnp.arange(n, dtype=jnp.int32),
                   ba=jnp.arange(a, dtype=jnp.int32),
                   mod_dur=jnp.ones((n,), jnp.int32), **lanes)
        return jproto.on_access(ctx, dict(cs), dict(bank))
    return f


def _port(tproto, tp, n, a, q_cap, cs, bank, lanes):
    t = convert.to_torch
    ctx = Ctx(p=tp, n=n, a=a, q_cap=q_cap,
              wc=torch.arange(n, dtype=torch.int32),
              ba=torch.arange(a, dtype=torch.int32),
              mod_dur=torch.ones((n,), dtype=torch.int32),
              **t(lanes, "cpu"))
    cs2, bank2 = tproto.on_access(ctx, t(cs, "cpu"), t(bank, "cpu"))
    return convert.to_numpy(cs2), convert.to_numpy(bank2)


def _assert_equal(got, want, where):
    assert set(got) == set(want), (where, sorted(got), sorted(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (where, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


def _outcome(st, nxt):
    if st == SLEEP:
        return OUT_SLEEP
    if st != RESP:
        return OUT_NONE
    return {NXT_MOD: OUT_GRANT, NXT_WORK_DONE: OUT_DONE,
            NXT_BACKOFF: OUT_FAIL}.get(int(nxt), OUT_NONE)


def _check_fused(tproto, tp, n, a, q_cap, cs, bank, lanes, cs2, bank2,
                 where):
    """on_access against fused_access + the engine's apply, and the
    non-winner lanes untouched."""
    win = lanes["win_core"]
    wcs = np.minimum(win, n - 1)
    fx = FusedCtx(p=tp, n=n, a=a, q_cap=q_cap, win=torch.from_numpy(win),
                  acq_b=torch.from_numpy(lanes["acq_b"]),
                  rel_b=torch.from_numpy(lanes["rel_b"]),
                  core={f: torch.from_numpy(cs[f][wcs])
                        for f in tproto.fused_core_fields})
    bank3, fo = tproto.fused_access(fx, convert.to_torch(bank, "cpu"))
    _assert_equal(convert.to_numpy(bank3), bank2, f"{where} fused bank")
    kind, tmr = fo.kind.numpy(), fo.tmr.numpy()
    msgs = 0 if fo.msgs is None else int(fo.msgs.sum())
    assert int(cs2["msgs"]) - int(cs["msgs"]) == msgs, where
    assert int(cs2["polls"]) - int(cs["polls"]) == int(
        (kind == OUT_FAIL).sum()), where
    xc = {k: cs[k].copy() for k in tproto.init_core_state(tp, n, "cpu")}
    for k, (val, msk) in fo.xset.items():
        sel = msk.numpy() & (win < n)
        xc[k][win[sel]] = val.numpy()[sel]
    for k in xc:
        np.testing.assert_array_equal(cs2[k], xc[k], err_msg=where)
    winner = np.zeros(n, bool)
    for b in range(a):
        if win[b] == n:
            assert kind[b] == OUT_NONE, where
            continue
        c = win[b]
        winner[c] = True
        assert _outcome(cs2["st"][c], cs2["nxt"][c]) == kind[b], (where, b)
        if kind[b] in (OUT_GRANT, OUT_DONE, OUT_FAIL):
            assert cs2["tmr"][c] == tmr[b], (where, b)
    off = ~winner
    for k in ("st", "tmr", "nxt", *xc):
        np.testing.assert_array_equal(cs2[k][off], cs[k][off],
                                      err_msg=f"{where} lane {k}")


@pytest.mark.parametrize(
    "name,fields", [pytest.param(pr, f, id=f"{pr}-" + "-".join(
        f"{k}{v}" for k, v in f.items())) for pr, f in CASES])
def test_on_access_matches_the_reference(name, fields):
    n, a = fields["n_cores"], fields["n_addrs"]
    tproto = tprotocols.get(name)
    tp = TParams(protocol=name, **fields)
    q_cap = tproto.q_cap(tp, n)
    assert q_cap == jprotocols.get(name).q_cap(
        JParams(protocol=name, backend="xla_cpu", **fields), n)
    ref = _reference(name, fields, n, a, q_cap)
    rng = np.random.default_rng([n, a, PROTOS.index(name), len(fields)])
    for i in range(STATES):
        bank, cs, lanes = _random_state(tproto, tp, n, a, q_cap, rng)
        where = f"{name} {fields} state {i}"
        jcs, jbank = ref({k: jnp.asarray(v) for k, v in cs.items()},
                         {k: jnp.asarray(v) for k, v in bank.items()},
                         {k: jnp.asarray(v) for k, v in lanes.items()})
        cs2, bank2 = _port(tproto, tp, n, a, q_cap, cs, bank, lanes)
        _assert_equal(cs2, jax.tree.map(np.asarray, jcs), f"{where} cs")
        _assert_equal(bank2, jax.tree.map(np.asarray, jbank),
                      f"{where} bank")
        _check_fused(tproto, tp, n, a, q_cap, cs, bank, lanes, cs2, bank2,
                     where)


def test_on_access_writes_no_input_in_place():
    """The checker hands the hooks views of its stored states."""
    rng = np.random.default_rng(5)
    for name in PROTOS:
        tproto = tprotocols.get(name)
        tp = TParams(protocol=name, n_cores=8, n_addrs=2)
        q_cap = tproto.q_cap(tp, 8)
        bank, cs, lanes = _random_state(tproto, tp, 8, 2, q_cap, rng)
        tb, tc = convert.to_torch(bank, "cpu"), convert.to_torch(cs, "cpu")
        before = ({k: v.clone() for k, v in tb.items()},
                  {k: v.clone() for k, v in tc.items()})
        ctx = Ctx(p=tp, n=8, a=2, q_cap=q_cap,
                  ba=torch.arange(2, dtype=torch.int32),
                  **convert.to_torch(lanes, "cpu"))
        tproto.on_access(ctx, dict(tc), dict(tb))
        for old, new in zip(before, (tb, tc)):
            for k in old:
                assert torch.equal(old[k], new[k]), (name, k)
