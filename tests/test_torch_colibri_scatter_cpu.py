"""The colibri_scatter kernel's own source, run on the CPU against the
plain version and the Pallas kernel.

``src/repro_torch/csrc/colibri_scatter.cu`` is compiled with g++ against
``tests/cuda_cpu_mock.h`` (the CUDA threads of a block as fibers on one
OS thread, barriers and warp exchanges as switches in a fixed order; a
look-back's pause lets the other threads run), as
``tests/engine_mock.py`` builds the engine kernels.  The
prelude below supplies what the source keeps under ``#ifndef
CUDA_CPU_MOCK`` (the relaxed 64-bit word accesses) and the CUDA types and
intrinsics the mock lacks (vector types, bf16, shuffles up and down).

Each case runs in a child process with a time limit (a look-back that
never finds its flag fails the case instead of hanging), and launches
the kernel four times on one scratch, as the wrapper does: twice with
the blocks in index order, once reversed and once in a seeded shuffle,
with the epoch one more each time.  The blocks take their chunks from
the atomic ticket, so the four outputs must have the same bits, and
the ticket must be back at 0 after every launch.  This checks the
kernel's indexing, segment logic, scan, look-back and scratch protocol,
not the GPU's compiler or its speed (``chip_smoke.py`` and
``tests/test_torch_gpu.py`` run the real build on the card).  Skips
without g++.
"""
import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.colibri_scatter.kernel import scatter_commit
from repro_torch.kernels.colibri_scatter import scatter_add_ref
from jax_cache import release_compiled  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "colibri_scatter.cu"
MOCK = Path(__file__).resolve().parent / "cuda_cpu_mock.h"

PRELUDE = r"""
#define CUDA_CPU_MOCK 1
#include "@MOCK@"
#include <random>
#undef __launch_bounds__
#define __launch_bounds__(...)
constexpr int cudaErrorInvalidValue = 1;
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct alignas(8) uint2 { uint32_t x, y; };
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 b) {
  return __uint_as_float(static_cast<uint32_t>(b.bits) << 16);
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {0x7fc0};      // NaN
  u += 0x7fffu + ((u >> 16) & 1u);                            // to nearest even
  return {static_cast<uint16_t>(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.bits; }
inline int __ffs(int v) { return __builtin_ffs(v); }

// shuffles of ints and floats through the mock's warp exchange
inline uint64_t mock_bits(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  return u;
}
inline float mock_float(uint64_t b) {
  return __uint_as_float(static_cast<uint32_t>(b));
}
inline int __shfl_up_sync(unsigned, int v, int off) {
  uint64_t o[32];
  mock_warp_exchange(static_cast<uint32_t>(v), o);
  const int l = threadIdx.x % 32;
  return l - off >= 0 ? static_cast<int>(static_cast<uint32_t>(o[l - off]))
                      : v;
}
inline float __shfl_up_sync(unsigned, float v, int off) {
  uint64_t o[32];
  mock_warp_exchange(mock_bits(v), o);
  const int l = threadIdx.x % 32;
  return l - off >= 0 ? mock_float(o[l - off]) : v;
}
inline float __shfl_down_sync(unsigned, float v, int off) {
  uint64_t o[32];
  mock_warp_exchange(mock_bits(v), o);
  const int l = threadIdx.x % 32;
  return l + off < 32 ? mock_float(o[l + off]) : v;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline int __reduce_min_sync(unsigned, int v) {
  uint64_t o[32];
  mock_warp_exchange(static_cast<uint32_t>(v), o);
  int r = v;
  for (int i = 0; i < 32; ++i)
    r = std::min(r, static_cast<int>(static_cast<uint32_t>(o[i])));
  return r;
}
inline unsigned long long atomicExch(unsigned long long* p,
                                     unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).exchange(v);
}

// the look-back's words: relaxed, single-copy atomic 64-bit accesses
inline unsigned long long load_word(const unsigned long long* p) {
  return std::atomic_ref<unsigned long long>(
             *const_cast<unsigned long long*>(p))
      .load(std::memory_order_relaxed);
}
inline void store_word(unsigned long long* p, unsigned long long w) {
  std::atomic_ref<unsigned long long>(*p).store(w, std::memory_order_relaxed);
}
inline void __nanosleep(unsigned) { mock_yield(); }

// The launch shim: the mock's, with the blocks in index order (0),
// reversed (1) or in a shuffle seeded by `seed` (2).
inline int mock_order = 0;
inline unsigned mock_seed = 0;
extern "C" void mock_set_order(int order, unsigned seed) {
  mock_order = order;
  mock_seed = seed;
}
template <class K, class... A>
void mock_launch_order(long long grid, int block, size_t smem, cudaStream_t,
                       K kern, A... args) {
  std::vector<long long> ids(grid);
  for (long long b = 0; b < grid; ++b) ids[b] = b;
  if (mock_order == 1) std::reverse(ids.begin(), ids.end());
  if (mock_order == 2) std::shuffle(ids.begin(), ids.end(),
                                    std::mt19937(mock_seed));
  blockDim = {static_cast<unsigned>(block), 1, 1};
  gridDim = {static_cast<unsigned>(grid), 1, 1};
  const std::function<void()> body = [&] { kern(args...); };
  for (long long b : ids) mock_run_block(b, block, smem, body);
}
"""

#: the child: numpy and ctypes only.  argv: library, inputs (.npz),
#: outputs (.npz).  Four launches on one scratch (orders 0, 0, 1, 2,
#: epochs 1-4), every output first filled with NaN so a bin left
#: unwritten shows; returns the four outputs and the high halves of the
#: scratch's words (epoch << 1 | head).
CHILD = r"""
import ctypes, sys
import numpy as np
lib_path, inp, outp = sys.argv[1:4]
z = np.load(inp)
keys, vals = z["keys"], z["vals"]
bins, dtype, offset = int(z["bins"]), int(z["dtype"]), int(z["offset"])
lib = ctypes.CDLL(lib_path)
lib.colibri_commit_scratch_words.argtypes = [ctypes.c_longlong, ctypes.c_int]
lib.colibri_commit_scratch_words.restype = ctypes.c_longlong
fn = lib.colibri_commit_launch
fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
fn.restype = ctypes.c_int
lib.mock_set_order.argtypes = [ctypes.c_int, ctypes.c_uint]
t, d = vals.shape

def placed(a):
    # a copy of a starting `offset` bytes past a 64-byte boundary
    buf = np.zeros(a.nbytes + 128, np.uint8)
    start = (-buf.ctypes.data) % 64 + offset
    view = buf[start:start + a.nbytes].view(a.dtype).reshape(a.shape)
    view[...] = a
    return view

k, x = placed(keys), placed(vals)
n_w = lib.colibri_commit_scratch_words(t, d)
words = np.zeros(n_w, np.uint64)
nan = np.float32(np.nan) if dtype == 0 else np.uint16(0x7fc0)
outs = []
for epoch, order in enumerate((0, 0, 1, 2), start=1):
    lib.mock_set_order(order, 7 * epoch)
    out = placed(np.full((bins, d), nan, vals.dtype))
    err = fn(k.ctypes.data, x.ctypes.data, out.ctypes.data, t, d, bins, dtype,
             words.ctypes.data, n_w, epoch, None)
    assert err == 0, f"launch error {err}"
    assert words[0] == 0, f"ticket left at {words[0]}"
    outs.append(out.copy())
np.savez(outp, *outs, flags=(words[1:] >> np.uint64(32)).astype(np.int64))
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
#: rows of one chunk at d = 1 (256 threads x 4 rows)
R = 1024


def mock_source() -> str:
    """The kernel source with the CUDA-only syntax rewritten for the mock."""
    src = SOURCE.read_text()
    src = src.replace("#include <cuda_bf16.h>\n", "")
    src = src.replace("#include <cuda_runtime.h>",
                      PRELUDE.replace("@MOCK@", str(MOCK)))
    return re.sub(r"(\w+)<<<(.*?)>>>\(", r"mock_launch_order(\2, \1, ", src,
                  flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("colibri_mock")
    cc, so = d / "colibri_scatter_mock.cc", d / "libcolibri_scatter_mock.so"
    cc.write_text(mock_source())
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-o", str(so), str(cc)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return so


def run_mock(lib_path, tmp_path, keys, vals, bins, dtype, offset=0):
    """The four launches of the mock build on ``keys`` (int32) and
    ``vals`` (float32, or bf16 as uint16 bits); returns the outputs (all
    four, bits) and the high halves of the scratch's words."""
    inp, outp = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, keys=keys, vals=vals, bins=bins, offset=offset,
             dtype=0 if dtype == "float32" else 1)
    proc = subprocess.run([sys.executable, "-c", CHILD, str(lib_path),
                           str(inp), str(outp)], capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    z = np.load(outp)
    return [z[f"arr_{i}"] for i in range(4)], z["flags"]


def torch_vals(vals, dtype):
    """``vals`` (float32 numpy) in ``dtype`` as a torch tensor, and its
    bits as the mock takes them."""
    tv = torch.from_numpy(vals).to(getattr(torch, dtype))
    bits = vals if dtype == "float32" else \
        tv.view(torch.int16).numpy().view(np.uint16)
    return tv, bits


def as_torch(out, dtype):
    if dtype == "float32":
        return torch.from_numpy(out)
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


def check(lib_path, tmp_path, keys, vals, bins, dtype, offset=0,
          exact=False):
    """The mock build on sorted ``keys`` and float32 ``vals`` (cast to
    ``dtype``) against ``scatter_add_ref``: four launches with equal
    bits, every bin written, floats within ``SCATTER_TOL`` (``exact``:
    equal, for counts).  Returns the output."""
    keys = np.ascontiguousarray(keys, np.int32)
    assert (np.diff(keys) >= 0).all()
    tv, bits = torch_vals(np.ascontiguousarray(vals, np.float32), dtype)
    outs, flags = run_mock(lib_path, tmp_path, keys, bits, bins, dtype,
                           offset)
    for o in outs[1:]:
        assert o.tobytes() == outs[0].tobytes(), "bits differ between runs"
    assert set(np.unique(flags >> 1)) <= {0, 4}, "a word of an old epoch"
    got = as_torch(outs[0], dtype)
    assert tuple(got.shape) == (bins, vals.shape[1])
    assert not torch.isnan(got.float()).any(), "a bin left unwritten"
    want = scatter_add_ref(torch.from_numpy(keys), tv, bins)
    if exact:
        assert torch.equal(got, want)
    else:
        rtol, atol = CS.SCATTER_TOL[dtype]
        assert torch.allclose(got.float(), want.float(), rtol=rtol,
                              atol=atol), \
            float((got.float() - want.float()).abs().max())
    return got


def uniform(t, lo, hi, d, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(lo, hi, t)).astype(np.int32)
    return keys, rng.standard_normal((t, d)).astype(np.float32)


@pytest.mark.parametrize("point", sorted(CS.TRACE_REF))
def test_trace_streams_give_the_reference_histograms(point, lib, tmp_path):
    """The trace path's four streams, rebuilt from their reference
    histograms (the sorted stream is the bins repeated by their counts):
    the counts come back exactly."""
    hist = np.asarray(CS.TRACE_REF[point]["trace_latency_hist"])
    keys = np.repeat(np.arange(hist.size), hist)
    got = check(lib, tmp_path, keys, np.ones((keys.size, 1)), hist.size,
                "float32", exact=True)
    np.testing.assert_array_equal(got[:, 0].numpy(), hist)


@pytest.mark.parametrize("t,d,dtype", [(6 * R + 5, 1, "float32"),
                                       (3 * R, 1, "bfloat16"),
                                       (70 * 128 + 7, 128, "float32")])
def test_one_key_spanning_many_chunks(t, d, dtype, lib, tmp_path):
    """One bin's segment over many chunks: its sum is carried by the
    look-back (at d = 128 over 70 chunks of 128 rows, three windows of
    8 row groups x 4 chunks)."""
    rng = np.random.default_rng([t, d])
    keys = np.full(t, 3, np.int32)
    keys[:7] = 1
    check(lib, tmp_path, keys, rng.standard_normal((t, d)), 8, dtype)


@pytest.mark.parametrize("t", [0, 1, R - 1, R, R + 1])
def test_stream_lengths_at_the_chunk_edges(t, lib, tmp_path):
    keys, vals = uniform(t, 0, 64, 1, seed=t)
    check(lib, tmp_path, keys, vals, 64, "float32")
    check(lib, tmp_path, keys, np.ones((t, 1)), 64, "float32", exact=True)


@pytest.mark.parametrize("d", [1, 8])
def test_keys_out_of_range_at_both_ends_are_dropped(d, lib, tmp_path):
    keys, vals = uniform(10_000, -5, 69, d, seed=d)
    assert keys[0] < 0 and keys[-1] >= 64
    check(lib, tmp_path, keys, vals, 64, "float32")


@pytest.mark.parametrize("lo,hi", [(-10, 0), (64, 80), (-10, 80)])
def test_no_key_in_range_gives_zeros(lo, hi, lib, tmp_path):
    keys, vals = uniform(5000, lo, hi, 1, seed=[lo + 10, hi])
    keys = keys[(keys < 0) | (keys >= 64)]
    got = check(lib, tmp_path, keys, vals[:keys.size], 64, "float32")
    assert torch.equal(got, torch.zeros((64, 1)))


def test_empty_leading_and_trailing_bins(lib, tmp_path):
    keys, vals = uniform(9000, 10, 50, 1, seed=3)
    keys[keys == 20] = 21                    # and an empty bin between
    got = check(lib, tmp_path, np.sort(keys), vals, 64, "float32")
    assert not got[:10].any() and not got[50:].any() and got[20] == 0


def test_skewed_stream(lib, tmp_path):
    """chip_smoke's Zipf stream (exponent 2 over 64 bins), cut to 13
    chunks: most rows in bin 0, one long look-back."""
    keys = CS.skewed_keys(50_000, 64, seed=1)
    assert (keys == 0).mean() > 0.5
    rng = np.random.default_rng(2)
    check(lib, tmp_path, keys, rng.standard_normal((keys.size, 1)), 64,
          "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 3, 8, 33, 128])
def test_widths_and_dtypes(d, dtype, lib, tmp_path):
    """Every column path: d = 1 (a run's rows by 16-byte loads), 3 and
    33 (one column a lane; 33 in two column tiles), 8 and 128 (16-byte
    loads across columns)."""
    keys, vals = uniform(3000, 0, 40, d, seed=[d, len(dtype)])
    check(lib, tmp_path, keys, vals, 40, dtype)


@pytest.mark.parametrize("d", [1, 8])
def test_unaligned_inputs(d, lib, tmp_path):
    """Pointers 4 bytes off 16-byte boundaries: keys and values loaded
    one element at a time."""
    keys, vals = uniform(5000, -2, 66, d, seed=d + 10)
    check(lib, tmp_path, keys, vals, 64, "float32", offset=4)


@pytest.mark.parametrize("t,bins,d,dtype", [(1000, 64, 8, "float32"),
                                            (1000, 64, 8, "bfloat16"),
                                            (513, 1, 4, "float32"),
                                            (2048, 300, 16, "float32")])
def test_agrees_with_the_pallas_kernel(t, bins, d, dtype, lib, tmp_path):
    """The Pallas kernel in interpret mode on the same numpy-seeded
    sorted stream (keys equal to ``bins`` and negative ones included),
    within tests/test_kernels.py's tolerances."""
    keys, vals = uniform(t, -1, bins + 1, d, seed=[t, bins, d])
    got = check(lib, tmp_path, keys, vals, bins, dtype)
    want = scatter_commit(jnp.asarray(keys), jnp.asarray(vals, dtype),
                          bins, interpret=True)
    rtol, atol = CS.SCATTER_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)
