"""The port's fused engine step against the reference's, bit for bit.

For each protocol the port's plain ``fused_step_ref`` is fed the same
seeded random state as the reference's ``fused_step_ref`` (XLA) and its
Pallas ``fused_step`` (interpret mode), and every output and every bank
array must be equal, dtypes included, over chained cycles.  The random
bank states are ``chip_smoke.random_bank``'s (the two-level queues'
drawn in the shape the protocols reach, nb_feb's full/empty bits apart
from its queue lengths), so the card's kernel phase starts from states
of the kind this file holds the reference to.  The CUDA
kernel itself runs only on a GPU: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold it against the plain version there.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocols as jprotocols
from repro.core.sim import SimParams as JParams
from repro.kernels.engine_step import fused_step as j_fused_step
from repro.kernels.engine_step import fused_step_ref as j_fused_step_ref
from repro_torch import convert
from repro_torch.core import protocols as tprotocols
from repro_torch.core.sim import SimParams as TParams
from repro_torch.kernels import engine_step
from repro_torch.kernels.engine_step import kernel as es_kernel
from repro_torch.kernels.engine_step.kernel import fused_step_cuda

PROTOS = ("amo", "lrsc", "lrscwait", "colibri", "amo_lock", "lrsc_lock",
          "ticket_lock", "mwait_lock", "colibri_hier", "hw_event", "nb_feb")
_BIG = 2**31 - 1
_OUT_KEYS = ("valid", "win", "kind", "tmr", "polls", "msgs", "hist",
             "lat_max")
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()
_random_bank = _CS.random_bank


def _random_core(proto, n, rng):
    """The protocol's per-core fields: held tickets, -1 for none."""
    return {f: rng.integers(-1, 8, n).astype(np.int32)
            for f in proto.fused_core_fields}


def _random_step(n, a, cyc, rng):
    shift = int(rng.integers(0, n))
    cand = rng.integers(0, cyc + 1, n).astype(np.int32)
    cand[rng.random(n) < 0.5] = _BIG
    return shift, dict(cand_cyc=cand,
                       rot=((np.arange(n) + shift) % n).astype(np.int32),
                       addr=rng.integers(0, a, n).astype(np.int32),
                       phase=rng.integers(0, 2, n).astype(np.int32),
                       acq_start=rng.integers(0, cyc + 1, n).astype(np.int32))


def _as_numpy(out):
    flat = {k: np.asarray(out[k]) for k in _OUT_KEYS}
    flat.update({f"bank.{k}": np.asarray(v) for k, v in out["bank"].items()})
    for k, (val, msk) in out["xset"].items():
        flat[f"xset.{k}"], flat[f"xset.{k}.mask"] = (np.asarray(val),
                                                     np.asarray(msk))
    return flat


def _assert_equal(got, want, where):
    assert set(got) == set(want), where
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k, got[k].dtype,
                                               want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where} {k}")


@pytest.mark.parametrize("n,a", [(64, 1), (64, 16), (128, 4), (2048, 512)])
@pytest.mark.parametrize("name", PROTOS)
def test_fused_step_ref_matches_reference_and_pallas(name, n, a):
    rng = np.random.default_rng([n, a, PROTOS.index(name)])
    jproto, tproto = jprotocols.get(name), tprotocols.get(name)
    jp = JParams(protocol=name, n_cores=n, n_addrs=a, backend="xla_cpu")
    tp = TParams(protocol=name, n_cores=n, n_addrs=a)
    q_cap = tproto.q_cap(tp, n)
    assert q_cap == jproto.q_cap(jp, n)
    bank0 = _random_bank(tproto, tp, a, n, q_cap, rng)
    bank_j = {k: jnp.asarray(v) for k, v in bank0.items()}
    bank_p = dict(bank_j)
    bank_t = convert.to_torch(bank0, "cpu")
    cyc = int(rng.integers(1000, 5000))
    cycles = cyc + 12                       # some grants retire past it
    for step in range(2 if n > 1024 else 3):
        shift, inp = _random_step(n, a, cyc, rng)
        core = _random_core(tproto, n, rng)
        sc = dict(cyc=cyc, shift=shift, lat=jp.lat, n=n, a=a,
                  q_cap=q_cap, cycles=cycles)
        core_j = {k: jnp.asarray(v) for k, v in core.items()}
        out_j = j_fused_step_ref(jproto, jp, bank_j, core=core_j,
                                 **{k: jnp.asarray(v) for k, v in inp.items()},
                                 **sc)
        out_p = j_fused_step(jproto, jp, bank_p, interpret=True, core=core_j,
                             **{k: jnp.asarray(v) for k, v in inp.items()},
                             **sc)
        out_t = engine_step.fused_step(tproto, tp, bank_t,
                                       core=convert.to_torch(core, "cpu"),
                                       **convert.to_torch(inp, "cpu"), **sc)
        want = _as_numpy(out_j)
        _assert_equal(_as_numpy(out_p), want, f"pallas {name} step {step}")
        _assert_equal(_as_numpy(convert.to_numpy(out_t)), want,
                      f"port {name} step {step}")
        bank_j, bank_p, bank_t = out_j["bank"], out_p["bank"], out_t["bank"]
        cyc += 1


def test_fused_step_ref_leaves_its_inputs_untouched():
    rng = np.random.default_rng(9)
    proto = tprotocols.get("colibri")
    p = TParams(protocol="colibri", n_cores=64, n_addrs=4)
    bank = convert.to_torch(_random_bank(proto, p, 4, 64, 64, rng), "cpu")
    before = {k: v.clone() for k, v in bank.items()}
    shift, inp = _random_step(64, 4, 100, rng)
    engine_step.fused_step_ref(proto, p, bank, **convert.to_torch(inp, "cpu"),
                               core={}, cyc=100, shift=shift, lat=5, n=64,
                               a=4, q_cap=64, cycles=20000)
    for k in bank:
        assert torch.equal(bank[k], before[k]), k


def test_outcome_counts_tally_each_code():
    kind = torch.tensor([0, 1, 1, 2, 3, 3, 3, 4], dtype=torch.int32)
    oc = engine_step.outcome_counts(kind)
    assert {k: int(v) for k, v in oc.items()} == dict(
        grants=2, retires=1, fails=3, enqueues=1)
    assert all(v.dtype == torch.int32 for v in oc.values())


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper checks its inputs before it builds or launches
    anything; CPU tensors go to the plain version, never to it."""
    proto = tprotocols.get("lrsc")
    p = TParams(protocol="lrsc", n_cores=8, n_addrs=2)
    bank = proto.init_bank_state(p, 2, 8, 8, "cpu")
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fused_step_cuda(proto, p, bank, cand_cyc=z, rot=z, addr=z, phase=z,
                        acq_start=z, core={}, cyc=0, shift=0, lat=5, n=8,
                        a=2, q_cap=8, cycles=100)


def test_build_dir_is_the_checkouts_when_run_from_source():
    root = Path(__file__).resolve().parents[1]
    assert es_kernel.build_dir() == root / "build" / "repro_torch"


def test_build_dir_of_an_installed_package_is_the_user_cache(
        tmp_path, monkeypatch):
    monkeypatch.setattr(es_kernel, "_PKG",
                        tmp_path / "lib" / "site-packages" / "repro_torch")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert es_kernel.build_dir() == tmp_path / "cache" / "repro_torch"
