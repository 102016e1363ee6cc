"""The port on an NVIDIA GPU: the CUDA kernels and a run through them.

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
from repro_torch.core import protocols
from repro_torch.core.sim import SimParams
from repro_torch.kernels import LAUNCHES, colibri_scatter, engine_step
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
