"""``engine_run_kernel``'s own source, run on the CPU against the plain loop.

``src/repro_torch/csrc/engine_step.cu`` is compiled with g++ against
``tests/cuda_cpu_mock.h`` (a CPU stand-in for the CUDA runtime: one
``std::thread`` per CUDA thread, real barriers, warp votes and
reductions, atomics), after two textual rewrites: the dynamic shared
memory declaration and the ``<<<...>>>`` launches (and with
``CUDA_CPU_MOCK`` defined, which leaves out the occupancy query).  The
library is driven through the wrapper's own packing (``run_scalars``,
``pack_runs``) on CPU tensors, and every key of the result must equal
``_simulate_plain(p, "cpu")``: each protocol at the
golden points, traced and untraced, with telemetry, workers, negative
and large seeds, two cores a thread (K = 2), per-core state in device
memory (more than 2 048 cores) and per-bank state in the scratch buffer
(more banks than shared memory holds).

The batched launch (a grid of run blocks, ``run_cuda_batch``'s packing
through ``pack_runs``) runs mixed batches whose blocks differ in
protocol, seed, live ``n_addrs`` below the bank bucket, queue capacity,
workers, cycles and trace switches, one of them on the scratch layout
with a scratch slice per block, with the blocks in index order and
reversed: each block's slice must equal ``_simulate_plain`` of its point
at the bucket.

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

if __name__ == "__main__":
    # a child process runs one case (the end of this file): it needs
    # neither the cases nor JAX, whose import would cost it seconds
    GOLDEN_CONFIGS, GOLDEN_EXTRA = (), None
else:
    from test_protocols import GOLDEN_CONFIGS, GOLDEN_EXTRA

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "engine_step.cu"
MOCK = Path(__file__).resolve().parent / "cuda_cpu_mock.h"


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
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
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
                   order: int = 0) -> list:
    """One launch of the mock build for the points ``kws``, block b's
    banks allocated at ``banks[b]``, the blocks run in index order (0)
    or reversed (1); each block against the plain loop: the keys that
    differ, per block."""
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
    smem = max(lib.engine_run_smem_bytes(n, sc["a"]) for _, _, sc in runs)
    err = lib.engine_run_launch(
        len(runs), n, packed["params"], len(K.RUN_PARAMS) - 1 + K.BO_TAB,
        packed["ptrs"], len(K.RUN_PTRS), smem, None)
    assert err == 0, err
    bad = []
    for (p, _, sc), out in zip(runs, packed["outs"]):
        del out["scalars"]
        bad.append(_diff(out, sim._simulate_plain(p, "cpu", banks=sc["a"])))
    return bad


def run_mock(lib_path: str, kw: dict) -> list:
    """One run of the mock build against the plain loop: the keys that
    differ (value, dtype, shape or order)."""
    return run_mock_batch(lib_path, [kw], [kw["n_addrs"]])[0]


TRACED = dict(record_trace=True, telemetry_windows=7)
PROTOS = ("amo", "lrsc", "lrscwait", "colibri")
CASES = [] if GOLDEN_EXTRA is None else (
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


def _child(lib, job: dict):
    """Run ``job`` in a child process (a deadlocked barrier fails the
    case instead of hanging); its JSON answer."""
    proc = subprocess.run(
        [sys.executable, __file__, str(lib), json.dumps(job)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("kw", CASES)
def test_kernel_source_on_the_cpu_equals_the_plain_loop(kw, mock_library):
    assert _child(mock_library, kw) == []


#: batches of one launch: (points, banks of each block, None for the
#: sweep's bucket).  "mixed": four protocols, live n_addrs below the
#: bucket (3 of 4, 5 of 8, 6 of 8), queue capacities 32 and 8, workers
#: with head-of-line blocking, seeds past the int32 range, different
#: cycles, traced and untraced; "scratch": two blocks whose banks live
#: in the scratch (a slice each) beside one in shared memory
BATCHES = {
    "mixed": ([
        dict(protocol="colibri", n_cores=32, n_addrs=3, cycles=120, seed=1,
             record_trace=True, telemetry_windows=8),
        dict(protocol="lrscwait", n_cores=32, n_addrs=5, q_slots=8,
             n_workers=6, net_bw=9, hol_block=4, work=2, modify=1,
             cycles=150, seed=-7),
        dict(protocol="lrsc", workload="zipf_histogram", zipf_skew=0,
             n_cores=32, n_addrs=6, backoff=16, backoff_exp=2, cycles=100,
             seed=2**40 + 3, record_trace=True),
        dict(protocol="amo", n_cores=32, n_addrs=1, lat=3, work=6,
             modify=2, cycles=130, seed=9)], None),
    "scratch": ([
        dict(protocol="lrsc", workload="zipf_histogram", zipf_skew=0,
             n_cores=32, n_addrs=6300, cycles=12, seed=3),
        dict(protocol="colibri", workload="zipf_histogram", zipf_skew=0,
             n_cores=32, n_addrs=6400, cycles=12, seed=4, record_trace=True,
             telemetry_windows=4),
        dict(protocol="amo", n_cores=32, n_addrs=3, cycles=12, seed=5)],
        [6300, 6400, 4]),
}


@pytest.mark.parametrize("order", [0, 1], ids=["index", "reversed"])
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batched_launch_equals_the_plain_loop_per_block(name, order,
                                                        mock_library):
    from repro_torch.core.sweep import _bucket_a
    kws, banks = BATCHES[name]
    banks = banks or [_bucket_a(kw["n_addrs"]) for kw in kws]
    assert any(b > kw["n_addrs"] for b, kw in zip(banks, kws))
    got = _child(mock_library, dict(batch=kws, banks=banks, order=order))
    assert got == [[]] * len(kws)


if __name__ == "__main__":
    job = json.loads(sys.argv[2])
    if "batch" in job:
        print(json.dumps(run_mock_batch(sys.argv[1], job["batch"],
                                        job["banks"], job["order"])))
    else:
        print(json.dumps(run_mock(sys.argv[1], job)))
