"""The engine kernels' own source on the CPU: build, launch, compare.

``src/repro_torch/csrc/engine_step.cu`` is compiled with g++ against
``tests/cuda_cpu_mock.h`` (every CUDA thread of a block a fiber on one OS
thread, barriers and warp exchanges switches in a fixed order, a barrier
that not all threads reach reported as a deadlock),
after two textual rewrites: the dynamic shared memory declaration and the
``<<<...>>>`` launches (and with ``CUDA_CPU_MOCK`` defined, which leaves
out the occupancy query).  The library is driven through the wrapper's
own packing (``run_scalars``, ``pack_runs``) on CPU tensors in a child
process, and every key of each block's result must equal
``_simulate_plain`` of its point, which the test's own process runs
meanwhile: same keys in the same order, dtypes, shapes and values.

The ``tests/test_torch_engine_run_*_cpu.py`` files hold the cases, one
file per protocol family, so that ``pytest --dist loadfile`` gives them
to different workers.  The child is this file, run as a script, with a
time limit: a crash or an abort fails the case, not the worker.  This
checks the kernel's logic and order, not the GPU's compiler or speed
(``chip_smoke.py`` and ``tests/test_torch_gpu.py`` run the real build on
the card).  The fixture skips without g++.
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

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "engine_step.cu"
MOCK = Path(__file__).resolve().parent / "cuda_cpu_mock.h"

#: telemetry and traces on, for the traced cases
TRACED = dict(record_trace=True, telemetry_windows=7)


def mock_source(src: str) -> str:
    """engine_step.cu with the CUDA-only syntax rewritten for the mock."""
    src = src.replace("#include <cuda_runtime.h>",
                      f'#define CUDA_CPU_MOCK 1\n#include "{MOCK}"')
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = mock_smem();")
    return re.sub(r"(\w+)<<<(.*?)>>>\(", r"mock_launch(\2, \1, ", src,
                  flags=re.S)


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


def _bind(lib_path: str):
    lib = ctypes.CDLL(lib_path)
    lib.engine_run_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    for fn in (lib.engine_run_scratch_bytes, lib.engine_run_smem_bytes):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_longlong
    lib.mock_set_block_order.argtypes = [ctypes.c_int]
    return lib


def _diff(out: dict, want: dict) -> list:
    if list(out) != list(want):
        return [f"keys {list(out)} != {list(want)}"]
    return [k for k, w in want.items()
            if out[k].dtype != w.dtype or out[k].shape != w.shape
            or not torch.equal(out[k], w)]


def run_mock_batch(lib_path: str, kws: list, banks: list,
                   order: int = 0, wide=None) -> list:
    """One launch of the mock build for the points ``kws``, block b's
    banks allocated at ``banks[b]``, the blocks run in index order (0)
    or reversed (1), on the kernel instance ``wide`` picks (default:
    the one the wrapper picks, ``launch_wide``): each block's result
    dict."""
    from repro_torch.core import protocols, sim, workloads
    from repro_torch.kernels.engine_step import kernel as K
    lib = _bind(lib_path)
    lib.mock_set_block_order(order)
    runs = []
    for kw, bk in zip(kws, banks):
        p = sim.SimParams(**kw)
        proto = protocols.get(p.protocol)
        runs.append((p, proto, K.run_scalars(
            p, proto, workloads.get(p.workload).program(p), bk)))
    n = runs[0][0].n_cores
    packed = K.pack_runs(runs, torch.device("cpu"),
                         lib.engine_run_scratch_bytes)
    scs = [sc for _, _, sc in runs]
    err = lib.engine_run_launch(
        len(runs), n, packed["params"], len(K.RUN_PARAMS) - 1 + K.BO_TAB,
        packed["ptrs"], len(K.RUN_PTRS), K.launch_smem(lib, scs),
        K.launch_wide(scs) if wide is None else wide, None)
    assert err == 0, err
    # each a copy: the views of the launch's buffer do not pickle
    return [{k: v.clone() for k, v in out.items() if k != "scalars"}
            for out in packed["outs"]]


def check_batch(lib, tmp_path, kws: list, banks: list,
                order: int = 0, wide=None) -> list:
    """The mock build's launch of ``kws`` (see :func:`run_mock_batch`) in
    a child process, while this one runs the plain loop of each point:
    the keys that differ (value, dtype, shape or order), per block.  A
    crash or a reported deadlock in the child fails the case, not the
    worker."""
    from repro_torch.core import sim
    out = tmp_path / "mock_out.pt"
    job = dict(batch=kws, banks=banks, order=order, wide=wide,
               out=str(out))
    proc = subprocess.Popen(
        [sys.executable, __file__, str(lib), json.dumps(job)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    try:
        want = [sim._simulate_plain(sim.SimParams(**kw), "cpu", banks=bk)
                for kw, bk in zip(kws, banks)]
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    got = torch.load(out)
    return [_diff(g, w) for g, w in zip(got, want)]


def check(lib, tmp_path, kw: dict) -> list:
    """One run of the mock build against the plain loop: the keys that
    differ."""
    return check_batch(lib, tmp_path, [kw], [kw["n_addrs"]])[0]


if __name__ == "__main__":
    # the child: one launch; it imports neither the cases nor JAX
    job = json.loads(sys.argv[2])
    torch.save(run_mock_batch(sys.argv[1], job["batch"], job["banks"],
                              job["order"], job["wide"]), job["out"])
