"""The flash-attention kernels' own sources, run on the CPU against the
plain versions.

``src/repro_torch/csrc/flash_attention_bwd.cu`` (the gradient) and
``flash_attention.cu`` (the forward, here for its ``lse`` output) are
compiled with g++ against ``tests/cuda_cpu_mock.h`` (the CUDA threads of
a block as fibers on one OS thread, barriers and warp exchanges as
switches in a fixed order), as ``tests/engine_mock.py`` builds the engine
kernel, and ``tests/cuda_cpu_mock_hopper.h`` (mbarriers, TMA's byte
bookkeeping, the warpgroup, wgmma descriptors; shared with
``tests/test_torch_recurrence_kernels_cpu.py``).  The PTX helpers each
source keeps under ``#ifndef CUDA_CPU_MOCK`` are replaced by the CPU
stand-ins below:

* the backward's bf16 ``wgmma`` m64nNk16: each thread's accumulators
  (warp w of its warpgroup: rows 16 w + g (+ 8), columns 8 n + 2 t
  (+ 1), g = lane / 4, t = lane % 4) from A by its shared-memory
  descriptor or from the warp's register fragments (a0 (g, 2t), a1 (g+8,
  2t), a2 (g, 2t+8), a3 (g+8, 2t+8), two bf16 each) and B by its
  descriptor, K-major or N-major (the transpose bit); each element read
  where the descriptor's start, LBO, SBO and layout type (the 128-byte
  swizzle included) put it, the card's canonical layouts;
* TMA boxes: synchronous copies of 64 columns, written with the 128-byte
  swizzle, columns past hd and positions past the sequence as 0, on a
  1 024-byte boundary, their bytes completing the mbarrier's phase;
  mbarriers: phases of arrivals and bytes, parity waits that let the
  block's other threads run; ``setmaxnreg`` and the wgmma wait: barriers
  of the warpgroup (every thread of it must reach them);
* for the forward: ``mma.sync.m16n8k16`` (bf16 x bf16 -> f32): each
  thread's four sums from the warp's A fragments (as above) and B
  fragments (b0 (k 2t, n g), b1 (k 2t+8, n g)), summed in k order;
  ``ldmatrix`` x4 (and ``.trans``): lanes 8i..8i+7 give matrix i's row
  addresses, each thread receives row lane / 4, elements 2 (lane % 4), +1
  (of the transpose with ``.trans``); ``cp.async``: a synchronous 16-byte
  copy, or zeros;
* ``ex2``: ``exp2f``; bf16: round to nearest even on 16-bit patterns.

This checks the kernels' indexing, masking, staging, ring and fragment
bookkeeping, not the GPU's compiler or speed (``chip_smoke.py``'s
flash_bwd_kernel phase and ``tests/test_torch_gpu.py`` run the real
build on the card).  Skips without g++.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_fwd_lse_ref)

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
struct alignas(8) uint2 { uint32_t x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

// bf16 as its 16-bit pattern, rounded to nearest even
struct __nv_bfloat16 { uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 mock_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {mock_bf16(lo), mock_bf16(hi)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {__bfloat162float(h.x), __bfloat162float(h.y)};
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  uint64_t o[32];
  mock_warp_exchange(0, o);
}
// every lane's values, once all 32 lanes of the warp have given theirs
inline uint64_t mock_lanes[16][32][8];
inline uint64_t* mock_put(int n, const uint64_t* v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < n; ++i) mock_lanes[w][l][i] = v[i];
  __syncwarp();
  return &mock_lanes[w][0][0];   // [lane * 8 + i]
}
inline float mock_f(uint64_t u) {
  const uint32_t b = static_cast<uint32_t>(u);
  float f;
  std::memcpy(&f, &b, 4);
  return f;
}
inline uint64_t mock_u(float f) {
  uint32_t b;
  std::memcpy(&b, &f, 4);
  return b;
}
inline float __shfl_sync(unsigned, float v, int src) {
  const uint64_t in = mock_u(v);
  const uint64_t* all = mock_put(1, &in);
  const float r = mock_f(all[(src & 31) * 8]);
  __syncwarp();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const uint64_t in = mock_u(v);
  const uint64_t* all = mock_put(1, &in);
  const float r = mock_f(all[((threadIdx.x % 32) ^ mask) * 8]);
  __syncwarp();
  return r;
}

inline void cp_async16(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16);
  else std::memset(dst, 0, 16);
}
inline void cp_async4(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 4);
  else std::memset(dst, 0, 4);
}
// the copies above land at once: the arrival follows them
inline void cp_async_arrive(uint64_t* bar) { mbar_arrive(bar); }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
inline void cp_async_wait_all() {}
inline float ex2(float x) { return std::exp2(x); }

inline uint16_t mock_b16(const void* p, int i) {
  uint16_t h;
  std::memcpy(&h, static_cast<const unsigned char*>(p) + 2 * i, 2);
  return h;
}
inline void mock_ldsm(uint32_t (&r)[4], const void* p, bool trans) {
  const uint64_t in = reinterpret_cast<uintptr_t>(p);
  const uint64_t* all = mock_put(1, &in);
  const int l = threadIdx.x % 32;
  auto row = [&](int lane) {
    return reinterpret_cast<const void*>(all[lane * 8]);
  };
  for (int i = 0; i < 4; ++i) {
    uint32_t lo, hi;
    if (trans) {
      lo = mock_b16(row(8 * i + 2 * (l & 3)), l >> 2);
      hi = mock_b16(row(8 * i + 2 * (l & 3) + 1), l >> 2);
    } else {
      lo = mock_b16(row(8 * i + (l >> 2)), 2 * (l & 3));
      hi = mock_b16(row(8 * i + (l >> 2)), 2 * (l & 3) + 1);
    }
    r[i] = lo | (hi << 16);
  }
  __syncwarp();
}
inline void ldsm_x4(uint32_t (&r)[4], const void* p) { mock_ldsm(r, p, false); }
inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  mock_ldsm(r, p, true);
}
inline float mock_half(uint32_t r, int k) {
  return __bfloat162float({static_cast<uint16_t>(k % 2 ? r >> 16 : r)});
}
inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                uint32_t b1) {
  const uint64_t in[6] = {a[0], a[1], a[2], a[3], b0, b1};
  const uint64_t* all = mock_put(6, in);
  const int l = threadIdx.x % 32, g = l >> 2, t = l & 3;
  auto A = [&](int r, int k) {
    const int lane = (r % 8) * 4 + (k % 8) / 2;
    const int reg = (r >= 8) + 2 * (k >= 8);
    return mock_half(static_cast<uint32_t>(all[lane * 8 + reg]), k);
  };
  auto B = [&](int k, int n) {
    const int lane = n * 4 + (k % 8) / 2;
    return mock_half(static_cast<uint32_t>(all[lane * 8 + 4 + (k >= 8)]), k);
  };
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    float s = d[e];
    for (int k = 0; k < 16; ++k) s += A(r, k) * B(k, n);
    d[e] = s;
  }
  __syncwarp();
}

// TMA: the (batch, seq, heads, hd) bf16 array of a map, boxes of 64
// columns x `rows` positions written with the 128-byte swizzle; columns
// past hd and positions past seq as 0
struct TensorMap {
  const uint16_t* base;
  int hd, heads, seq, batch, rows;
};
inline int make_map(TensorMap* m, const void* base, int hd, int heads,
                    int seq, int batch, int rows) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || rows < 1 || rows > 256)
    mock_fail("TMA map: base off 16 bytes or box rows out of range");
  *m = TensorMap{static_cast<const uint16_t*>(base), hd, heads, seq, batch,
                 rows};
  return 0;
}
inline void tma_load(void* dst, const TensorMap* m, int c0, int h, int s,
                     int b, uint64_t* bar) {
  mock_box_aligned(dst, 1024);    // the swizzle's 8-row pattern
  const uint32_t at = smem_addr(dst);
  if (at + 128u * m->rows > mock_dynamic_smem.size())
    mock_fail("TMA box past the end of shared memory");
  for (int r = 0; r < m->rows; ++r)
    for (int c = 0; c < 64; ++c) {
      const uint16_t x = c0 + c < m->hd && s + r < m->seq
          ? m->base[((static_cast<int64_t>(b) * m->seq + s + r) * m->heads
                     + h) * m->hd + c0 + c] : 0;
      std::memcpy(mock_smem() + mock_sw128(at + 128 * r + 2 * c), &x, 2);
    }
  mock_complete(bar, 128LL * m->rows);
}

// bf16 wgmma m64nNk16: this thread's accumulators (warp w of its
// warpgroup: rows 16 w + g (+ 8), columns 8 n + 2 t (+ 1)) from A by its
// descriptor (K-major) or as the warp's register fragments (mma.sync
// m16n8k16's A: a0 (g, 2t..), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8,
// 2t+8..)) and B by its descriptor, K-major or (trans) N-major; exact
// products of bf16, summed in f32 in k order
inline float mock_bf16_at(uint64_t d, int mn, int k, bool mn_major) {
  uint16_t h;
  std::memcpy(&h, mock_smem() + mock_desc_offset(d, mn, k, 2, mn_major), 2);
  return __bfloat162float({h});
}
template <int R>
inline void mock_wgmma_bf16(float (&d)[R], uint64_t a, const uint32_t* areg,
                            uint64_t b, bool b_trans, int add) {
  const int w = (threadIdx.x / 32) % 4, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4;
  uint32_t lanes[32][4];
  if (areg) mock_warp_regs(areg, lanes);
  // this thread's two rows of A and R / 2 columns of B, each read once
  float av[2][16], bv[R / 2][16];
  for (int h = 0; h < 2; ++h) {
    const int rl = g + 8 * h;
    for (int k = 0; k < 16; ++k)
      av[h][k] = areg ? mock_half(lanes[(rl % 8) * 4 + (k % 8) / 2]
                                       [(rl >= 8) + 2 * (k >= 8)], k)
                      : mock_bf16_at(a, 16 * w + rl, k, false);
  }
  for (int n = 0; n < R / 2; ++n)
    for (int k = 0; k < 16; ++k)
      bv[n][k] = mock_bf16_at(b, 8 * (n / 2) + 2 * t + n % 2, k, b_trans);
  for (int e = 0; e < R; ++e) {
    const float* ar = av[(e / 2) % 2];
    const float* br = bv[2 * (e / 4) + e % 2];
    float s = add ? d[e] : 0.0f;
    for (int k = 0; k < 16; ++k) s += ar[k] * br[k];
    d[e] = s;
  }
}
inline void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int add) {
  mock_wgmma_bf16(d, a, nullptr, b, false, add);
}
template <int R>
inline void wgmma_rs(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
  mock_wgmma_bf16(d, 0, a, b, true, 1);
}

// kernel<<<grid, block, smem, stream>>>(args...) with a 1-D or 2-D grid
template <class K, class... A>
void mock_launch2(dim3 grid, int block, size_t smem, cudaStream_t, K kern,
                  A... args) {
  blockDim = {static_cast<unsigned>(block), 1, 1};
  gridDim = {grid.x, grid.y, 1};
  for (unsigned y = 0; y < grid.y; ++y) {
    const std::function<void()> body = [&] {
      blockIdx.y = y;
      kern(args...);
    };
    for (long long j = 0; j < grid.x; ++j) {
      mock_run_block(mock_block_order == 1 ? grid.x - 1 - j : j, block, smem,
                     body);
    }
  }
}
"""


def mock_source(name: str) -> str:
    """``csrc/<name>.cu`` with the CUDA-only syntax rewritten for the
    mock."""
    src = (CSRC / f"{name}.cu").read_text()
    src = src.replace("#include <cuda_bf16.h>", "")
    src = src.replace("#include <cuda_runtime.h>",
                      PRELUDE.replace("@MOCK@", str(MOCK))
                      .replace("@HOPPER@", str(HOPPER)))
    src = src.replace("extern __shared__ float4 smem4[];",
                      "float4* smem4 = reinterpret_cast<float4*>(mock_smem());")
    return re.sub(r"([\w<>:]+?)<<<(.*?)>>>\(", r"mock_launch2(\2, \1, ", src,
                  flags=re.S)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    d = tmp_path_factory.mktemp("flash_mock")
    out = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        cc, lib = d / f"{name}_mock.cc", d / f"lib{name}_mock.so"
        cc.write_text(mock_source(name))
        proc = subprocess.run(
            [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-o", str(lib),
             str(cc)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        out[name] = ctypes.CDLL(str(lib))
    for fn in (out["flash_attention"].flash_attention_lse_launch,):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for fn in (out["flash_attention_bwd"].flash_attention_bwd_dq_launch,
               out["flash_attention_bwd"].flash_attention_bwd_dkdv_launch):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return out


DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fwd_mock(lib, q, k, v, causal, window=0):
    """The mock build of ``flash_attention_lse_launch``: (o, lse)."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    o = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, sq), float("nan"))
    err = lib.flash_attention_lse_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, sq, skv, h, kv, hd, int(causal), window,
        hd ** -0.5, DTYPES[q.dtype], None)
    assert err == 0
    return o, lse


def bwd_mock(lib, q, k, v, o, do, lse, causal, window=0):
    """The mock build of the two backward launches: (dq, dk, dv)."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    delta = torch.full_like(lse, float("nan"))
    dims = (b, sq, skv, h, kv, hd, int(causal), window, hd ** -0.5,
            DTYPES[q.dtype], None)
    assert lib.flash_attention_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *dims) == 0
    assert lib.flash_attention_bwd_dkdv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *dims) == 0
    return dq, dk, dv


def inputs(b, sq, skv, h, kv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(dtype) for s in ((b, sq, h, hd), (b, skv, kv, hd),
                                        (b, skv, kv, hd), (b, sq, h, hd)))
    return q, k, v, do


#: (b, sq, skv, h, kv, hd, causal): GQA groups of 2, 3 and 1, ragged
#: tiles (sq, skv not multiples of 32 or 64), every head dim the backward
#: takes, causal and not
SHAPES = [(2, 70, 70, 4, 2, 32, True), (1, 45, 77, 3, 1, 64, False),
          (1, 66, 66, 3, 3, 112, True), (1, 40, 40, 2, 1, 128, False)]
#: bf16 only, the tensor-core design's hazards: more query tiles a head
#: than ring stages (and a last key block with fewer), Skv > Sq and a
#: second consumer with no keys, hd 112's two boxes a row causal with
#: GQA, hd 32 with more key tiles than stages in dq
BF16_SHAPES = [(1, 300, 300, 3, 1, 64, True), (1, 70, 150, 2, 2, 128, False),
               (1, 150, 150, 4, 2, 112, True), (2, 200, 200, 2, 1, 32, False)]
#: both dtypes, the instances and the band of the local layers: hd 80
#: (stablelm-3b) and 96 (phi-3-vision) causal with GQA and ragged tiles,
#: the window (50 inside a key tile, 70 across tiles, 1: a row sees only
#: itself) at hd 64 and 32, hd 256 (recurrentgemma-2b: 4 heads on 1, the
#: CUDA-core design in both dtypes) with a window and without
WIDE_SHAPES = [(1, 90, 90, 4, 2, 80, True, 0),
               (1, 75, 75, 3, 1, 96, True, 0),
               (1, 150, 150, 4, 2, 64, True, 50),
               (1, 200, 200, 2, 1, 32, True, 70),
               (2, 45, 45, 3, 3, 32, True, 1),
               (1, 70, 70, 4, 1, 256, True, 20),
               (1, 40, 40, 2, 1, 256, False, 0)]
#: bf16 only: whisper's cross-attention (Sq < Skv, non-causal, MHA) with
#: a last key tile of 28, as at 1 500 frames, at hd 64, and a band that
#: spans more query tiles than the ring has stages at hd 96
WIDE_BF16_SHAPES = [(1, 20, 220, 2, 2, 64, False, 0),
                    (1, 330, 330, 2, 1, 96, True, 130)]
CASES = [(s + (0,), dt) for s in SHAPES
         for dt in (torch.float32, torch.bfloat16)] \
    + [(s + (0,), torch.bfloat16) for s in BF16_SHAPES] \
    + [(s, dt) for s in WIDE_SHAPES
       for dt in (torch.float32, torch.bfloat16)] \
    + [(s, torch.bfloat16) for s in WIDE_BF16_SHAPES]
#: dtype -> (rtol, atol) of the gradients against the plain version: f32
#: sums in another order; bf16 also rounds P and dS to bf16 before the
#: products (the plain version keeps f32) and the outputs to bf16
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}


@pytest.mark.parametrize(
    "shape,dtype", CASES,
    ids=["x".join(map(str, s[:-1])) + (f"-w{s[-1]}" if s[-1] else "") + "-"
         + str(dt).split(".")[-1] for s, dt in CASES])
def test_backward_kernel_source_matches_plain(libs, shape, dtype):
    *dims, causal, window = shape
    q, k, v, do = inputs(*dims, dtype, seed=list(dims))
    o, lse = fwd_mock(libs["flash_attention"], q, k, v, causal, window)
    o_ref, lse_ref = flash_attention_fwd_lse_ref(q, k, v, causal=causal,
                                                 window=window)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=1e-5,
                               atol=1e-5 if dtype == torch.float32 else 2e-3)
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                   window=window)
    rtol, atol = TOL[dtype]
    got = bwd_mock(libs["flash_attention_bwd"], q, k, v, o, do, lse, causal,
                   window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)
    # blocks in reversed order: the same bits (no block reads another's)
    libs["flash_attention_bwd"].mock_set_block_order(1)
    try:
        again = bwd_mock(libs["flash_attention_bwd"], q, k, v, o, do, lse,
                         causal, window)
    finally:
        libs["flash_attention_bwd"].mock_set_block_order(0)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_forward_lse_leaves_the_output_unchanged(libs, dtype):
    """The lse entry computes o as the serving entry does: the same bits
    with and without lse (here: against the entry with lse = null)."""
    q, k, v, _ = inputs(1, 50, 50, 4, 2, 64, dtype, seed=3)
    lib = libs["flash_attention"]
    o, _ = fwd_mock(lib, q, k, v, True)
    bare = torch.full_like(q, float("nan"))
    assert lib.flash_attention_lse_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bare.data_ptr(), None, 1,
        50, 50, 4, 2, 64, 1, 0, 64 ** -0.5, DTYPES[dtype], None) == 0
    assert torch.equal(o, bare)


def test_backward_refuses_other_head_dims(libs):
    q, k, v, do = inputs(1, 8, 8, 2, 2, 32, torch.float32, seed=0)
    fn = libs["flash_attention_bwd"].flash_attention_bwd_dq_launch
    lse = torch.zeros(1, 2, 8)
    for hd in (16, 48, 192):
        assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), lse.data_ptr(),
                  q.data_ptr(), 1, 8, 8, 2, 2, hd, 1, 0, 1.0, 0, None) != 0
    # a window needs causal attention and Sq <= Skv, and is >= 0
    for causal, window in ((0, 4), (1, -1)):
        assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), lse.data_ptr(),
                  q.data_ptr(), 1, 8, 8, 2, 2, 32, causal, window, 1.0, 0,
                  None) != 0


def test_backward_abi_tells_the_bindings_apart(libs):
    """The source's ``flash_attention_bwd_abi()`` is the version the
    wrapper binds, and ``tools/kernel_ab.py`` binds a base build by it:
    the signature before the window where the symbol is absent, this
    tree's at this version, and a raise at another."""
    import importlib.util
    import types

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    lib = libs["flash_attention_bwd"]
    assert lib.flash_attention_bwd_abi() == fa_kernel.BWD_ABI
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", ROOT / "tools" / "kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    assert ab.base_bwd_args(lib) == fa_kernel.BWD_ARGS
    assert ab.base_bwd_args(types.SimpleNamespace()) \
        == ab.BASE_FLASH_BWD_ARGS
    assert len(ab.BASE_FLASH_BWD_ARGS) == len(fa_kernel.BWD_ARGS) - 1
    later = types.SimpleNamespace(
        flash_attention_bwd_abi=lambda: fa_kernel.BWD_ABI + 1)
    with pytest.raises(RuntimeError, match="ABI"):
        ab.base_bwd_args(later)
