"""The reference's ``colibri_hier`` invariants
(``tests/test_protocols.py::test_colibri_hier_*``), run on the port on
the CPU: polling-free with round-robin fairness across groups, at least
0.8 of flat Colibri's throughput at 1 and 16 bins, and progress with no
poll at 1, 2 and 8 groups.
"""
from repro_torch import sync as tsync


def _run(**kw):
    return tsync.run(device="cpu", **kw)


def test_colibri_hier_polling_free_and_fair():
    r = _run(protocol="colibri_hier", n_cores=64, n_addrs=1, cycles=8000)
    s = r.stats
    assert int(s["polls"]) == 0
    assert int(s["sleep_cyc"]) > 0
    span = int(s["ops"].max()) - int(s["ops"].min())
    assert span <= 3, span                      # round-robin groups
    assert int(s["ops"].sum()) > 0


def test_colibri_hier_tracks_flat_colibri():
    for bins in (1, 16):
        hier = _run(protocol="colibri_hier", n_cores=64, n_addrs=bins,
                    cycles=8000)
        flat = _run(protocol="colibri", n_cores=64, n_addrs=bins,
                    cycles=8000)
        assert hier.throughput >= 0.8 * flat.throughput
    assert int(hier.polls) == 0


def test_colibri_hier_group_count_axis():
    for g in (1, 2, 8):
        r = _run(protocol="colibri_hier", n_groups=g, n_cores=64,
                 n_addrs=2, cycles=5000)
        assert int(r.polls) == 0
        assert int(r.stats["ops"].sum()) > 0
