"""Shared by the port's workload-program tests: the reference against
the port on the CPU, key for key, and the laws the programs keep.

``assert_matches_reference`` runs one point through
``repro.core.sim.execute`` and ``repro_torch.sync.run`` (the port's
``Result``), holds every key of the port's result to the reference's
(``pc``, ``bar_cnt``, ``ops``, ``bar_cyc``, ``tele`` and ``trace_step``
included), asserts the identities the run kernel's design rests on
(``program_identities``) on the reference's result, and runs the
workload's laws on the port's (``Result.check()``; no poll for the
polling-free protocols).  ``own_program`` registers ``tests/own_program.py``'s
program in both registries for the length of a ``with`` block.
"""
import contextlib

import numpy as np

from own_program import OWN, OWN_FIELDS, OWN_MIN_ADDRS
from repro.core import sim as jsim
from repro.core import workloads as jworkloads
from repro.core.workloads import base as jbase
from repro.core.workloads import registry as jregistry
from repro_torch import sync as tsync
from repro_torch.core.workloads import base as tbase
from repro_torch.core.workloads import registry as tregistry

PROTOS = ("amo", "amo_lock", "colibri", "colibri_hier", "hw_event", "lrsc",
          "lrsc_lock", "lrscwait", "mwait_lock", "nb_feb", "ticket_lock")
#: tests/test_workloads.py's: no poll under any workload
POLLING_FREE = {"lrscwait", "colibri", "colibri_hier", "mwait_lock"}

@contextlib.contextmanager
def own_program():
    """``OWN`` registered in the reference's and the port's registries,
    removed again on exit."""
    made = []
    for reg, base in ((jregistry, jbase), (tregistry, tbase)):
        wl = base.Workload()
        wl.name, wl.min_addrs = OWN, OWN_MIN_ADDRS
        wl.program = lambda p, _b=base: _b.Program(**OWN_FIELDS)
        reg.register(wl)
        made.append(reg)
    try:
        yield
    finally:
        for reg in made:
            del reg._REGISTRY[OWN]


def program_identities(res, prog) -> None:
    """``pc == opc % L``, ``ops == opc // L`` and ``bar_cnt == (opc // L)
    * n_bar + (barrier steps before opc % L)``, core by core."""
    L = len(prog.kind)
    bars = np.array([k == jworkloads.K_BARRIER for k in prog.kind], int)
    prefix = np.concatenate([[0], np.cumsum(bars)[:-1]])
    opc = np.asarray(res["opc"])
    np.testing.assert_array_equal(np.asarray(res["pc"]), opc % L)
    np.testing.assert_array_equal(np.asarray(res["ops"]), opc // L)
    np.testing.assert_array_equal(np.asarray(res["bar_cnt"]),
                                  (opc // L) * bars.sum() + prefix[opc % L])


def assert_matches_reference(proto: str, workload: str, **kw):
    """The point on the reference and on the port (CPU), key for key;
    returns the port's ``Result`` after its laws held."""
    want = jsim.execute(jsim.SimParams(protocol=proto, workload=workload,
                                       backend="xla_cpu", **kw))
    r = tsync.run(protocol=proto, workload=workload, device="cpu", **kw)
    got = r.stats
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), k
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and g == w, (k, g, w)
    p = r.spec.to_params()
    program_identities(want, jworkloads.get(workload).program(p))
    info = r.check()
    assert info["atomics"] > 0, "no atomic retired"
    assert info["atomics"] >= info["ops"]
    if proto in POLLING_FREE:
        assert int(r.polls) == 0, f"{proto} polled under {workload}"
    return r
