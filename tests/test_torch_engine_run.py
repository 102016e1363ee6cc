"""The whole-run engine kernel (``engine_run``) on the CPU: its per-run
scalars, its C interface and its routing.

The CUDA kernel runs only on a GPU (``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold it against the plain loop there), and its source
runs on the CPU against the plain loop through a g++ build
(``tests/engine_mock.py``).  Here:

* ``run_scalars`` gives the values the plain loop (``_simulate_plain``)
  derives, for the eleven protocols, with and without workers, for
  negative and large seeds, and every workload's step tables;
* ``RUN_PARAMS``/``RUN_PTRS``/``RUN_SCALARS`` name the source's enums in
  order, and ``pack_runs`` lays out what the plain loop returns;
* ``run_cuda`` refuses a CPU device, and ``simulate`` on a CUDA device
  goes to ``run_cuda`` (with a stand-in launcher: no card needed).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import protocols as tprotocols
from repro_torch.core import sim
from repro_torch.core import workloads as tworkloads
from repro_torch.core.protocols.base import KernelArgs
from repro_torch.core.workloads.base import ADDR_ZIPF, zipf_index
from repro_torch.kernels import engine_step
from repro_torch.kernels.engine_step import kernel as es_kernel
from repro_torch.obs.schema import window_len
from jax_cache import release_compiled  # noqa: F401

PROTOS = ("amo", "lrsc", "lrscwait", "colibri", "amo_lock", "lrsc_lock",
          "ticket_lock", "mwait_lock", "colibri_hier", "hw_event", "nb_feb")
SOURCE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc" / "engine_step.cu"
_M32 = 0xFFFFFFFF


def _params(proto, workers=False, **kw):
    kw.setdefault("n_cores", 48)
    kw.setdefault("n_addrs", 4)
    if workers:
        kw.update(n_workers=6, net_bw=13, hol_block=16)
    return sim.SimParams(protocol=proto, **kw)


def _scalars(p):
    return engine_step.run_scalars(
        p, tprotocols.get(p.protocol),
        tworkloads.get(p.workload).program(p))


# ---------------------------------------------------------------------------
# the per-run scalars
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [False, True])
@pytest.mark.parametrize("proto", PROTOS)
def test_run_scalars_are_what_the_plain_loop_derives(proto, workers):
    """Each value against the plain loop's own expression for it."""
    for seed in (0, 7, -1, -(2**40) + 3, 2**31, 2**63 - 1):
        for wl, extra in (("rmw_loop", {}),
                          ("zipf_histogram", dict(zipf_skew=0)),
                          ("ms_queue", {}), ("treiber_stack", {}),
                          ("barrier_phases", {})):
            p = _params(proto, workers, seed=seed, workload=wl,
                        backoff=96, backoff_exp=4, work=7, modify=3,
                        record_trace=seed == 7, telemetry_windows=5,
                        cycles=333, **extra)
            pr = tprotocols.get(proto)
            pt = tworkloads.get(wl).program(p).tables()
            sc = _scalars(p)
            exp_cap = 1 if pr.fixed_backoff else p.backoff_exp
            assert sc["seed"] == (p.seed & _M32)
            assert 0 <= sc["seed"] < 2**32
            assert sc["exp_cap"] == exp_cap
            bo_plain = [sim.shl32(p.backoff, max(k - 1, 0))
                        for k in range(exp_cap + 1)]
            for k, v in enumerate(bo_plain):
                assert sc["bo_tab"][min(k, es_kernel.BO_TAB - 1)] == v
            assert len(sc["bo_tab"]) == es_kernel.BO_TAB
            # the step tables: each step's entry, zeros past the program
            L = len(pt["kind"])
            assert sc["prog_len"] == L
            bars = [int(k == tworkloads.K_BARRIER) for k in pt["kind"]]
            assert sc["n_bar"] == sum(bars)
            for j in range(es_kernel.MAX_STEPS):
                if j >= L:
                    assert all(sc[k][j] == 0 for k in (
                        "pre_dur", "mod_dur", "addr_mode", "fix_addr",
                        "is_bar", "bar_prefix"))
                    continue
                assert sc["pre_dur"][j] == (int(pt["pre_mult"][j]) * p.work
                                            + int(pt["pre_add"][j]))
                assert sc["mod_dur"][j] == (int(pt["mod_mult"][j])
                                            * p.modify
                                            + int(pt["mod_add"][j]))
                assert sc["addr_mode"][j] == int(pt["addr_mode"][j])
                assert sc["fix_addr"][j] == (int(pt["addr_arg"][j])
                                             & _M32) % p.n_addrs
                assert sc["is_bar"][j] == bars[j]
                assert sc["bar_prefix"][j] == sum(bars[:j])
            assert tuple(sc[k] for k in KernelArgs._fields) \
                == pr.kernel_args(p)
            # lrscwait's finite queue rejects when full, mwait_lock's and
            # nb_feb's never
            assert sc["q_full"] == (
                sc["q_cap"] if proto in ("lrscwait", "colibri")
                else 2**31 - 1 if proto in ("mwait_lock", "nb_feb") else 0)
            # the two-level queues' geometry is their own _geom's
            if proto in ("colibri_hier", "hw_event"):
                assert (sc["groups"], sc["group_size"], sc["group_cap"]) \
                    == pr._geom(p, p.n_cores)
                assert sc["wake_delay"] == p.lat + (
                    2 if proto == "colibri_hier" else 1)
            else:
                assert sc["groups"] == sc["group_cap"] == 0
            # an LR/SC pair answers an acquire after two round trips
            assert sc["acq_tmr"] == p.lat * (2 if proto == "lrsc_lock"
                                             else 1)
            assert sc["q_cap"] == pr.q_cap(p, p.n_cores)
            assert sc["proto"] == pr.kernel_code
            assert sc["n_atomic"] == p.n_cores - min(p.n_workers,
                                                     p.n_cores)
            assert sc["stagger"] == p.work + 1
            assert sc["hol_block"] == p.hol_block
            assert sc["net_bw"] == p.net_bw
            assert sc["n_workers"] == p.n_workers
            assert sc["trace"] == int(p.record_trace)
            assert sc["tele_cw"] == window_len(p.cycles, 5)
            if ADDR_ZIPF in sc["addr_mode"]:
                # fma(u, c, 1), one rounding, with the host's c is
                # zipf_index at skew 0 (u * c + 1 rounded after each op
                # is not: it differs at most counts that are not powers
                # of two); float64 holds u * c + 1 exactly
                h = torch.arange(0, 1 << 24, 4099, dtype=torch.int64)
                u = h.to(torch.float64) * 2.0**-24
                x = (u * sc["zipf_c"] + 1.0).to(torch.float32)
                mine = (torch.floor(x).to(torch.int32) - 1).clamp_(
                    0, p.n_addrs - 1)
                assert torch.equal(mine, zipf_index(h, p.n_addrs, 0))
                assert sc["zipf_n_thr"] == 0 and sc["zipf_thr"] is None


def test_run_scalars_bo_tab_past_32_doublings_is_zero():
    p = _params("lrsc", backoff=160, backoff_exp=50)
    sc = _scalars(p)
    assert sc["bo_tab"][33] == 0 == sim.shl32(160, 49)
    assert sc["bo_tab"][32] == sim.shl32(160, 31)


def test_packed_params_follow_the_source_layout():
    """The words the wrapper packs are RUN_PARAMS in order, the float's
    bits and the seed's two's complement included."""
    p = _params("colibri", seed=2**32 - 5, workload="zipf_histogram",
                zipf_skew=0, n_addrs=16)
    sc = _scalars(p)
    words = es_kernel._pack_params(sc)
    assert len(words) == es_kernel.N_PARAM_WORDS
    assert all(-(2**31) <= w < 2**31 for w in words)
    at, pos = {}, 0
    for k in es_kernel.RUN_PARAMS:
        at[k] = pos
        pos += es_kernel.PARAM_SPANS.get(k, 1)
    assert pos == len(words)
    assert words[at["seed"]] == -5
    assert np.int32(words[at["zipf_c"]]).view(np.float32) == np.float32(16)
    for k, span in es_kernel.PARAM_SPANS.items():
        assert words[at[k]:at[k] + span] == list(sc[k])


def _enum(name):
    body = re.search(r"enum %s \{(.*?)\};" % name, SOURCE.read_text(),
                     re.S).group(1)
    return [t.split("=")[0].strip() for t in body.split(",") if t.strip()]


def test_python_layout_names_the_source_enums_in_order():
    params = [t[2:].lower() for t in _enum("Param")]
    assert params == list(es_kernel.RUN_PARAMS)
    ptrs = [t[2:].lower() for t in _enum("Ptr") if t != "kNumPtrs"]
    assert ptrs == list(es_kernel.RUN_PTRS)
    scalars = [t[2:].lower() for t in _enum("Scalar") if t != "kNumScalars"]
    assert scalars == list(es_kernel.RUN_SCALARS)
    assert f"constexpr int kBoTab = {es_kernel.BO_TAB};" in \
        SOURCE.read_text()
    assert f"constexpr int kMaxSteps = {es_kernel.MAX_STEPS};" in \
        SOURCE.read_text()


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("proto", PROTOS)
def test_run_outputs_lay_out_the_plain_result(proto, traced):
    """Keys in order, dtypes and shapes of the kernel's outputs are the
    plain loop's; the bank state starts as the protocol's."""
    p = _params(proto, cycles=20, record_trace=traced,
                telemetry_windows=3 * traced)
    pr = tprotocols.get(proto)
    out = es_kernel.pack_runs([(p, pr, _scalars(p))], "cpu")["outs"][0]
    scal = out.pop("scalars")
    assert scal.shape == (len(es_kernel.RUN_SCALARS),)
    want = sim._simulate_plain(p, "cpu")
    assert list(out) == list(want)
    for k, w in want.items():
        assert (out[k].dtype, out[k].shape) == (w.dtype, w.shape), k
    for k, v in pr.init_bank_state(p, p.n_addrs, p.n_cores,
                                   pr.q_cap(p, p.n_cores), "cpu").items():
        assert torch.equal(out[k], v)
    for k in es_kernel.RUN_SCALARS:
        if k not in want:                # a fault plan's, absent here
            assert not p.faults.enabled and k not in out
            continue
        assert out[k].data_ptr() == scal[es_kernel.RUN_SCALARS.index(k)] \
            .data_ptr()


# ---------------------------------------------------------------------------
# refusals and routing
# ---------------------------------------------------------------------------

def test_run_cuda_refuses_cpu_tensors():
    p = _params("colibri", cycles=10)
    with pytest.raises(ValueError, match="CUDA"):
        engine_step.run_cuda(p, tprotocols.get("colibri"),
                             tworkloads.get(p.workload).program(p), "cpu")


def test_simulate_on_cuda_makes_one_run_launch(monkeypatch):
    """``simulate`` on a CUDA device calls ``run_cuda`` once and never
    the plain loop (a stand-in launcher records the call)."""
    calls = []

    def launcher(p, proto, prog, dev):
        calls.append((p, proto.name, prog, dev))
        return {"ok": True}

    def plain(*a):
        raise AssertionError("the plain loop ran on a CUDA device")

    monkeypatch.setattr(engine_step, "run_cuda", launcher)
    monkeypatch.setattr(sim, "_simulate_plain", plain)
    p = _params("lrsc", cycles=10)
    assert sim.simulate(p, "cuda") == {"ok": True}
    assert len(calls) == 1
    assert calls[0][0] is p and calls[0][1] == "lrsc"
    assert calls[0][3] == torch.device("cuda")
    assert calls[0][2] == tworkloads.get(p.workload).program(p)


def test_simulate_on_cpu_runs_the_plain_loop(monkeypatch):
    def launcher(*a):
        raise AssertionError("run_cuda called on the CPU")

    monkeypatch.setattr(engine_step, "run_cuda", launcher)
    r = sim.simulate(_params("amo", cycles=30), "cpu")
    assert r["st"].device.type == "cpu"



def test_kernels_refuse_what_they_have_no_branch_for():
    """A protocol without a kernel branch, or with per-core fields other
    than its family's, is refused by both kernels' wrappers (no
    fallback); the ticket lock's held tickets are taken; every protocol
    the port registers (all of the reference's) has a branch."""
    from repro_torch.core.protocols.base import KERNEL_AMO, Protocol

    class NoBranch(Protocol):
        name = "no_branch"

    class OtherCore(Protocol):
        name = "other_core"
        kernel_code = KERNEL_AMO
        fused_core_fields = fused_xset_fields = ("x",)

    for pr in (NoBranch(), OtherCore()):
        for kernel in ("engine_step", "engine_run"):
            with pytest.raises(NotImplementedError, match=pr.name):
                es_kernel._require_branch(pr, kernel)
    ticket = tprotocols.get("ticket_lock")
    es_kernel._require_branch(ticket, "engine_run")
    es_kernel._require_branch(ticket, "engine_step",
                              {"tkt": torch.zeros(4, dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match="ticket_lock"):
        es_kernel._require_branch(ticket, "engine_step", {})
    from repro.core import protocols as jprotocols
    assert tprotocols.names() == jprotocols.names()
    for name in tprotocols.names():
        pr = tprotocols.get(name)
        for kernel in ("engine_step", "engine_run"):
            es_kernel._require_branch(pr, kernel)
