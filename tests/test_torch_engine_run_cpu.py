"""``engine_run_kernel``'s own source, run on the CPU against the plain loop.

``src/repro_torch/csrc/engine_step.cu`` is compiled with g++ against
``tests/cuda_cpu_mock.h`` (a CPU stand-in for the CUDA runtime: one
``std::thread`` per CUDA thread, real barriers, warp votes and
reductions, atomics), after two textual rewrites: the dynamic shared
memory declaration and the ``<<<...>>>`` launches.  The library is
driven through the wrapper's own packing (``run_scalars``,
``run_outputs``, ``RUN_PTRS``) on CPU tensors, and every key of the
result must equal ``_simulate_plain(p, "cpu")``: each protocol at the
golden points, traced and untraced, with telemetry, workers, negative
and large seeds, two cores a thread (K = 2), per-core state in device
memory (more than 2 048 cores) and per-bank state in the scratch buffer
(more banks than shared memory holds).

This checks the kernel's logic and order, not the GPU's compiler or
speed (``chip_smoke.py`` and ``tests/test_torch_gpu.py`` run the real
build on the card).  Each case runs in a child process with a time
limit, so a barrier that deadlocks fails the case instead of hanging.
Skips without g++.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_protocols import GOLDEN_CONFIGS, GOLDEN_EXTRA

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "engine_step.cu"
MOCK = Path(__file__).resolve().parent / "cuda_cpu_mock.h"


def mock_source(src: str) -> str:
    """engine_step.cu with the CUDA-only syntax rewritten for the mock."""
    src = src.replace("#include <cuda_runtime.h>",
                      f'#include "{MOCK}"')
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = mock_smem();")
    return re.sub(r"(\w+)<<<(.*?)>>>\(", r"mock_launch(\2, \1, ", src)


@pytest.fixture(scope="module")
def mock_library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("engine_mock")
    cc, lib = d / "engine_mock.cc", d / "libengine_mock.so"
    cc.write_text(mock_source(SOURCE.read_text()))
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-o", str(lib), str(cc)], capture_output=True,
        text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return lib


def run_mock(lib_path: str, kw: dict) -> list:
    """One run of the mock build against the plain loop: the keys that
    differ (value, dtype, shape or order)."""
    from repro_torch.core import protocols, sim, workloads
    from repro_torch.kernels.engine_step import kernel as K
    lib = ctypes.CDLL(lib_path)
    lib.engine_run_launch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p]
    lib.engine_run_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.engine_run_scratch_bytes.restype = ctypes.c_longlong
    p = sim.SimParams(**kw)
    proto = protocols.get(p.protocol)
    sc = K.run_scalars(p, proto, workloads.get(p.workload).program(p))
    out = K.run_outputs(p, proto, sc, torch.device("cpu"))
    n_scratch = lib.engine_run_scratch_bytes(sc["n"], sc["a"])
    tensors = dict(out, scratch=(torch.empty(n_scratch, dtype=torch.uint8)
                                 if n_scratch else None))
    ptrs = [tensors[k].data_ptr() if tensors.get(k) is not None else None
            for k in K.RUN_PTRS]
    words = K._pack_params(sc)
    err = lib.engine_run_launch((ctypes.c_int32 * len(words))(*words),
                                len(words),
                                (ctypes.c_void_p * len(ptrs))(*ptrs),
                                len(ptrs), None)
    assert err == 0, err
    del out["scalars"]
    want = sim._simulate_plain(p, "cpu")
    if list(out) != list(want):
        return [f"keys {list(out)} != {list(want)}"]
    return [k for k, w in want.items()
            if out[k].dtype != w.dtype or out[k].shape != w.shape
            or not torch.equal(out[k], w)]


TRACED = dict(record_trace=True, telemetry_windows=7)
PROTOS = ("amo", "lrsc", "lrscwait", "colibri")
CASES = (
    [pytest.param(dict(protocol=pr, **cfg), id=f"{pr}/{i}")
     for pr in PROTOS for i, cfg in enumerate(GOLDEN_CONFIGS)]
    + [pytest.param(dict(GOLDEN_EXTRA[k][0]), id=k)
       for k in ("colibri_workers", "lrsc_workers")]
    + [pytest.param(dict(protocol="lrscwait", **GOLDEN_EXTRA["lrscwait_q8"][0],
                         telemetry_windows=64), id="lrscwait_q8/tele"),
       pytest.param(dict(protocol="colibri", workload="zipf_histogram",
                         zipf_skew=0, n_cores=64, n_addrs=16, cycles=1500,
                         seed=-12345, record_trace=True,
                         telemetry_windows=64), id="colibri/zipf/traced"),
       pytest.param(dict(protocol="lrsc", workload="zipf_histogram",
                         zipf_skew=0, n_cores=40, n_addrs=3, cycles=1500,
                         seed=2**40 + 9, n_workers=4, net_bw=9,
                         record_trace=True, telemetry_windows=7),
                    id="lrsc/zipf/workers/traced")]
    + [pytest.param(dict(protocol=pr, n_cores=64, n_addrs=16, cycles=500,
                       seed=2, **TRACED), id=f"{pr}/64x16/traced")
     for pr in PROTOS]
    + [pytest.param(dict(protocol=pr, workload="zipf_histogram",
                         zipf_skew=0, n_cores=40, n_addrs=4, cycles=500,
                         lat=3, work=6, modify=2, net_bw=5, seed=-3),
                    id=f"{pr}/40x4/zipf")
       for pr in PROTOS]
    + [pytest.param(dict(protocol="colibri", n_cores=64, n_addrs=1,
                         n_workers=8, net_bw=13, hol_block=16, cycles=600,
                         backoff=128, backoff_exp=1, seed=5, **TRACED),
                    id="colibri/workers/traced"),
       pytest.param(dict(protocol="lrscwait", n_cores=64, n_addrs=1,
                         q_slots=8, cycles=600, seed=4), id="lrscwait/q8"),
       pytest.param(dict(protocol="lrsc", workload="zipf_histogram",
                         zipf_skew=0, n_cores=1500, n_addrs=64, cycles=80,
                         seed=7, **TRACED), id="lrsc/two-cores-a-thread"),
       pytest.param(dict(protocol="colibri", workload="zipf_histogram",
                         zipf_skew=0, n_cores=2100, n_addrs=7000, cycles=50,
                         seed=9, **TRACED),
                    id="colibri/cores-and-banks-in-device-memory")])


@pytest.mark.parametrize("kw", CASES)
def test_kernel_source_on_the_cpu_equals_the_plain_loop(kw, mock_library):
    proc = subprocess.run(
        [sys.executable, __file__, str(mock_library), json.dumps(kw)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []


if __name__ == "__main__":
    print(json.dumps(run_mock(sys.argv[1], json.loads(sys.argv[2]))))
