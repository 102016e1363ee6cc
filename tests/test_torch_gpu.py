"""The port on an NVIDIA GPU: the CUDA kernel and a run through it.

Every test here is marked ``gpu`` and skips without a CUDA device (the
CUDA kernel has no CPU mode).  The file imports neither JAX nor the
reference package, so it runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The expected values come from ``chip_smoke.py``, whose embedded
reference values ``tests/test_torch_sync.py`` recomputes with JAX.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import protocols
from repro_torch.core.sim import SimParams
from repro_torch.kernels import LAUNCHES, engine_step
from repro_torch.sync import Spec, run

PROTOS = ("amo", "lrsc", "lrscwait", "colibri")
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
    before = LAUNCHES["engine_step"]
    gpu = run(Spec(protocol="colibri", **cfg))
    assert LAUNCHES["engine_step"] == before + cfg["cycles"]
    cpu = run(Spec(protocol="colibri", **cfg), device="cpu")
    want = cs.GOLDEN["colibri/1"]
    obs = cs.observe(gpu.stats)
    assert {k: obs[k] for k in want} == want
    assert cs.int_keys_equal(gpu.stats, cpu.stats) == []
