"""The recurrence kernels' own sources, run on the CPU against the plain
versions.

``src/repro_torch/csrc/rwkv6_wkv.cu`` and ``rglru_scan.cu`` are compiled
with g++ against ``tests/cuda_cpu_mock.h`` (the CUDA threads of a block
as fibers on one OS thread, barriers and warp exchanges as switches in a
fixed order), as ``tests/engine_mock.py`` builds the engine kernel.  The
few PTX helpers each source keeps under
``#ifndef CUDA_CPU_MOCK`` are replaced by the CPU stand-ins below:

* ``wgmma`` m64nNk8 TF32: each thread computes its accumulators (warp w
  of the warpgroup: rows 16 w + g (+ 8), columns 8 n + 2 t (+ 1), with g
  = lane / 4, t = lane % 4) from the tiles its shared-memory descriptors
  state (start, LBO, SBO; no swizzle, K-major) or, for a register A,
  from the warp's m16n8k8 A fragments (a0 (g, t), a1 (g+8, t), a2 (g,
  t+4), a3 (g+8, t+4)), reading the top 19 bits of each operand; the
  wait is a barrier of the warpgroup's 128 threads (the card's wgmma
  reads are done by then);
* the TMA boxes: synchronous copies that check the alignment the card
  needs and read past an array's end as 0; the mbarrier: phases that
  complete when their arrivals are in and the bytes expected have been
  copied, and a wait on one lets the other threads run (``mock_yield``).
  The mbarrier, warpgroup and descriptor stand-ins are
  ``tests/cuda_cpu_mock_hopper.h``'s, shared with
  ``tests/test_torch_flash_bwd_cpu.py``;
* acquire/release flags: ``std::atomic_ref``.

Blocks run one after another, so the rglru look-back always finds the
tile before inclusive (the aggregate path is emulated in
``tests/test_torch_recurrence_numerics.py``).  This checks the kernels'
indexing, masking, staging and synchronisation, not the GPU's compiler,
the descriptor and fragment layouts (the card checks those) or speed
(``chip_smoke.py`` and ``tests/test_torch_gpu.py`` run the real build on
the card).  Each case runs in a child process with a time limit.  Skips
without g++.
"""
import ctypes
import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
MOCK = Path(__file__).resolve().parent / "cuda_cpu_mock.h"
HOPPER = Path(__file__).resolve().parent / "cuda_cpu_mock_hopper.h"

PRELUDE = r"""
#define CUDA_CPU_MOCK 1
#include "@MOCK@"
#include "@HOPPER@"
#undef __launch_bounds__
#define __launch_bounds__(...)
#define __grid_constant__
constexpr int cudaErrorInvalidValue = 1;
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  uint64_t o[32];
  mock_warp_exchange(0, o);
}
// every lane's values, once all 32 lanes of the warp have given theirs
inline float mock_lanes[32][32][4];
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  mock_lanes[w][l][0] = v;
  __syncwarp();
  const float r = mock_lanes[w][src][0];
  __syncwarp();
  return r;
}
@MAPS@

// wgmma (tf32).  A descriptor as the source builds it: no swizzle, the
// tile's shared-memory offset, LBO and SBO, each in 16-byte units
inline uint64_t desc(const float* p, int lbo = 128, int sbo = 256) {
  return (smem_addr(p) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}
// element (row, k) of the K-major tile a descriptor points to
inline float mock_at(uint64_t d, int row, int k) {
  float x;
  std::memcpy(&x, mock_smem() + mock_desc_offset(d, row, k, 4, false), 4);
  return x;
}
// d (+)= a b for this thread's accumulators (warp w of the warpgroup: rows
// 16 w + g (+ 8), columns 8 n + 2 t (+ 1)), operands' top 19 bits; a (64
// x 8) by a descriptor, or (areg) as each warp's m16n8k8 A fragments
template <int R>
inline void mock_wgmma(float (&d)[R], uint64_t a, const uint32_t* areg,
                       uint64_t b, int add) {
  auto tf = [](float x) {
    return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  };
  const int w = (threadIdx.x / 32) % 4, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4;
  uint32_t lanes[32][4];
  if (areg) mock_warp_regs(areg, lanes);
  // this thread's two rows of A and R / 2 columns of B, each read once
  float av[2][8], bv[R / 2][8];
  for (int h = 0; h < 2; ++h) {
    const int rl = g + 8 * h;
    for (int k = 0; k < 8; ++k)
      av[h][k] = tf(areg ? __uint_as_float(lanes[(rl % 8) * 4 + k % 4]
                                                [(rl >= 8) + 2 * (k >= 4)])
                         : mock_at(a, 16 * w + rl, k));
  }
  for (int n = 0; n < R / 2; ++n)
    for (int k = 0; k < 8; ++k)
      bv[n][k] = tf(mock_at(b, 8 * (n / 2) + 2 * t + n % 2, k));
  for (int e = 0; e < R; ++e) {
    const float* ar = av[(e / 2) % 2];
    const float* br = bv[2 * (e / 4) + e % 2];
    float s = add ? d[e] : 0.0f;
    for (int k = 0; k < 8; ++k) s += ar[k] * br[k];
    d[e] = s;
  }
}
inline void wgmma16(float (&d)[8], uint64_t a, uint64_t b, int add) {
  mock_wgmma(d, a, nullptr, b, add);
}
inline void wgmma16(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                    int add) {
  mock_wgmma(d, 0, a, b, add);
}
template <int R>
inline void wgmma_n(float (&d)[R], uint64_t a, uint64_t b) {
  mock_wgmma(d, a, nullptr, b, 1);
}

// the look-back's flags and scratch
inline int load_flag(const int* p) {
  return std::atomic_ref<int>(*const_cast<int*>(p))
      .load(std::memory_order_acquire);
}
inline void store_flag(int* p, int f) {
  std::atomic_ref<int>(*p).store(f, std::memory_order_release);
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline void __nanosleep(unsigned) { mock_yield(); }
inline float __ldcg(const float* p) { return *p; }
inline void __stcg(float* p, float v) { *p = v; }
"""


#: each source's TMA maps: a box of rows of one array, rows past its end
#: (or lanes past its width) as 0
MAPS = {"rwkv6_wkv": r"""
// (batch, t_len, heads, hd) float32 by its strides; boxes hd x 1 x 64 x 1
struct TensorMap {
  const float* base;
  long long hd, heads, t_len, batch, sh, st, sb;
};
inline int make_map(TensorMap* m, const float* base, int hd, long long heads,
                    long long t_len, long long batch, long long sh,
                    long long st, long long sb) {
  *m = TensorMap{base, hd, heads, t_len, batch, sh, st, sb};
  return 0;
}
inline void tma_load(float* dst, const TensorMap* m, int h, int t, int b,
                     uint64_t* bar) {
  mock_box_aligned(dst);
  for (int row = 0; row < 64; ++row)
    for (int c = 0; c < m->hd; ++c)
      dst[row * m->hd + c] = t + row < m->t_len
          ? m->base[b * m->sb + (t + row) * m->st + h * m->sh + c] : 0.0f;
  mock_complete(bar, 64 * m->hd * 4);
}
""", "rglru_scan": r"""
// (t_len, batch, width) float32 by its strides; boxes 128 x 1 x 64
struct TensorMap {
  const float* base;
  long long t_len, batch, width, st, sb;
};
inline int make_map(TensorMap* m, const float* base, long long t_len,
                    long long batch, long long width, long long st,
                    long long sb) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || st % 4 || sb % 4)
    mock_fail("TMA map off 16-byte boundaries");
  *m = TensorMap{base, t_len, batch, width, st, sb};
  return 0;
}
inline void tma_load(float* dst, const TensorMap* m, int c0, int b, int t,
                     uint64_t* bar) {
  mock_box_aligned(dst);
  for (int row = 0; row < 64; ++row)
    for (int c = 0; c < 128; ++c)
      dst[row * 128 + c] = t + row < m->t_len && c0 + c < m->width
          ? m->base[(t + row) * m->st + b * m->sb + c0 + c] : 0.0f;
  mock_complete(bar, 64 * 128 * 4);
}
"""}


def mock_source(name: str) -> str:
    """``csrc/<name>.cu`` with the CUDA-only syntax rewritten for the mock."""
    src = (CSRC / f"{name}.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>",
                      PRELUDE.replace("@MOCK@", str(MOCK))
                      .replace("@HOPPER@", str(HOPPER))
                      .replace("@MAPS@", MAPS[name]))
    src = re.sub(r"extern __shared__ __align__\(\d+\) float (\w+)\[\];",
                 r"float* \1 = reinterpret_cast<float*>(mock_smem());", src)
    return re.sub(r"([\w<>]+?)<<<(.*?)>>>\(", r"mock_launch(\2, \1, ", src,
                  flags=re.S)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    d = tmp_path_factory.mktemp("recurrence_mock")
    out = {}
    for name in ("rwkv6_wkv", "rglru_scan"):
        cc, lib = d / f"{name}_mock.cc", d / f"lib{name}_mock.so"
        cc.write_text(mock_source(name))
        proc = subprocess.run(
            [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-o",
             str(lib), str(cc)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        out[name] = str(lib)
    return out


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def wkv_mock(lib_path, r, k, v, w, u):
    """The mock build of ``rwkv6_wkv_launch`` on CPU tensors, as
    ``kernels/rwkv6_wkv/kernel.py::wkv_cuda`` calls it."""
    from repro_torch.kernels.rwkv6_wkv.kernel import _axis_strides
    fn = ctypes.CDLL(lib_path).rwkv6_wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    b, t, h, hd = r.shape
    out = torch.full((b, t, h, hd), float("nan"))
    state = torch.full((b, h, hd, hd), float("nan"))
    sb, st, sh, _ = _axis_strides(r)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), out.data_ptr(), state.data_ptr(), b, t, h, hd, sb,
             st, sh, None)
    assert err == 0
    return out, state


def rglru_mock(lib_path, a, x, h0):
    """The mock build of ``rglru_scan_launch``, as
    ``kernels/rglru_scan/kernel.py::rglru_scan_cuda`` calls it."""
    lib = ctypes.CDLL(lib_path)
    for name in ("rglru_scan_scratch_ints", "rglru_scan_scratch_floats"):
        getattr(lib, name).argtypes = [ctypes.c_longlong] * 3
        getattr(lib, name).restype = ctypes.c_longlong
    fn = lib.rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 10 \
        + [ctypes.c_void_p] * 3
    t, b, w = a.shape
    out = torch.full_like(a, float("nan"))
    ints = torch.zeros(lib.rglru_scan_scratch_ints(t, b, w),
                       dtype=torch.int32)
    floats = torch.full((lib.rglru_scan_scratch_floats(t, b, w),),
                        float("nan"))
    err = fn(a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(), t, b,
             w, a.stride(0), a.stride(1), x.stride(0), x.stride(1),
             out.stride(0), out.stride(1), h0.stride(0), ints.data_ptr(),
             floats.data_ptr(), None)
    assert err == 0
    assert (ints[:-1] == 2).all()             # every tile ended inclusive
    return out


def _run_child(fn_name: str, lib_path: str, case) -> None:
    """Run ``fn_name(lib_path, case)`` of this module in a child process
    with a time limit, so a barrier that deadlocks fails the case."""
    code = (f"import sys; sys.path[:0] = {[str(ROOT / 'src'), str(ROOT / 'tests')]!r}; "
            f"import test_torch_recurrence_kernels_cpu as m; "
            f"m.{fn_name}({lib_path!r}, {case!r})")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]


def _wkv_inputs(b, t, h, hd, decay, seed, pad_heads):
    """r, k, v, w as ``(B, T, H, hd)`` views of ``(B, T, H + pad, hd)``
    tensors (strided along T and B when pad > 0), and u."""
    rng = np.random.default_rng(seed)
    shape = (b, t, h + pad_heads, hd)
    r = rng.standard_normal(shape) * 0.5
    k = rng.standard_normal(shape) * 0.5
    v = rng.standard_normal(shape)
    w = np.exp(-np.exp(rng.standard_normal(shape) + decay))
    u = rng.standard_normal((h, hd)) * 0.1
    return [torch.from_numpy(x.astype(np.float32))[:, :, :h]
            for x in (r, k, v, w)] + [torch.from_numpy(u.astype(np.float32))]


def check_wkv(lib_path, case):
    from repro_torch.kernels.rwkv6_wkv import wkv_ref
    shape, decay, pad = case
    ins = _wkv_inputs(*shape, decay, seed=[*shape, pad], pad_heads=pad)
    out, state = wkv_mock(lib_path, *ins)
    want_out, want_state = wkv_ref(*ins)
    rtol, atol = CS.RWKV_TOL
    assert torch.allclose(out, want_out, rtol=rtol, atol=atol), \
        float((out - want_out).abs().max())
    assert torch.allclose(state, want_state, rtol=rtol, atol=atol), \
        float((state - want_state).abs().max())


def check_rglru(lib_path, case):
    from repro_torch.kernels.rglru_scan import rglru_scan_ref
    (t, b, w), layout = case
    rng = np.random.default_rng([t, b, w, len(layout)])

    def draw(shape):
        return rng.standard_normal(shape).astype(np.float32)
    if layout == "batch_major":             # the model's (B, T, w) views
        a = torch.sigmoid(torch.from_numpy(draw((b, t, w))) + 2.0)
        x = torch.from_numpy(draw((b, t, w))) * 0.3
        a, x = a.transpose(0, 1), x.transpose(0, 1)
    elif layout == "offset":                # no row on a 16-byte boundary
        a = torch.sigmoid(torch.from_numpy(draw((t * b * w + 1,))) + 2.0)
        x = torch.from_numpy(draw((t * b * w + 1,))) * 0.3
        a, x = a[1:].view(t, b, w), x[1:].view(t, b, w)
    else:
        a = torch.sigmoid(torch.from_numpy(draw((t, b, w))) + 2.0)
        x = torch.from_numpy(draw((t, b, w))) * 0.3
    h0 = torch.from_numpy(draw((b, w)))
    got = rglru_mock(lib_path, a, x, h0)
    assert got.stride() == a.stride()
    want = rglru_scan_ref(a, x, h0)
    rtol, atol = CS.RGLRU_TOL
    assert torch.allclose(got, want, rtol=rtol, atol=atol), \
        float((got - want).abs().max())


#: (B, T, H, hd), decay mean, padding heads (strides along T and B): one
#: step, a ragged last sub-tile and chunk, each head dim, strided inputs
WKV_CASES = [((1, 1, 2, 64), 1.0, 0), ((1, 130, 1, 64), -5.0, 0),
             ((2, 40, 2, 16), 0.0, 1), ((1, 70, 1, 32), -1.5, 2),
             ((1, 64, 1, 64), 1.0, 1)]
#: (T, B, w) and layout: one step, ragged chunks, widths that are not a
#: multiple of the 128-lane tile (60, 200) or of 4 (6), the model's
#: transposed views, and rows off 16-byte boundaries
RGLRU_CASES = [((1, 2, 60), "contiguous"), ((130, 2, 200), "batch_major"),
               ((100, 3, 6), "contiguous"), ((65, 2, 256), "offset"),
               ((200, 1, 128), "batch_major")]


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_kernel_source_matches_the_plain_version(case, libs):
    _run_child("check_wkv", libs["rwkv6_wkv"], case)


@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_rglru_kernel_source_matches_the_plain_version(case, libs):
    _run_child("check_rglru", libs["rglru_scan"], case)
