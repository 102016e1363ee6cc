// CPU stand-ins for Hopper's asynchronous machinery, on top of
// tests/cuda_cpu_mock.h: mbarriers, the bookkeeping of TMA copies, the
// warpgroup (its barrier, `setmaxnreg`, the wgmma fence, commit and wait)
// and the layouts a wgmma descriptor names.  The kernel tests that run a
// source with TMA and wgmma (tests/test_torch_recurrence_kernels_cpu.py,
// tests/test_torch_flash_bwd_cpu.py) include it after cuda_cpu_mock.h and
// add the copies and products of their own types on top.
//
// Copies and products run synchronously: a TMA box is written when it is
// issued, a wgmma computes when it is issued.  What the card does
// asynchronously shows here as an order: a phase of an mbarrier completes
// when its arrivals and its announced bytes are all in, a wait on one
// lets the block's other threads run, and a wgmma wait is a barrier of
// the warpgroup's 128 threads.
#pragma once
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>

inline void mock_fail(const char* what) {
  std::fprintf(stderr, "mock: %s\n", what);
  std::abort();
}

// a shared-memory address: its offset in the block's dynamic shared
// memory, as the card's shared window numbers it
inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) -
                               mock_smem());
}

// ---- mbarriers --------------------------------------------------------

// a phase completes once `count` threads have arrived and the bytes the
// phase announced have all been copied
struct MockBar {
  int count = 1, arrived = 0;
  long long pending = 0;
  int done = 0;  // phases completed
};
inline std::map<const void*, std::unique_ptr<MockBar>> mock_bars;
inline MockBar& mock_bar(const void* p) {
  auto& b = mock_bars[p];
  if (!b) b = std::make_unique<MockBar>();
  return *b;
}
inline void mock_bar_check(MockBar& b) {
  if (b.arrived == b.count && b.pending == 0) {
    b.arrived = 0;
    ++b.done;
  }
}
inline void mbar_init(uint64_t* bar, uint32_t count = 1) {
  MockBar& b = mock_bar(bar);
  b = MockBar{};
  b.count = static_cast<int>(count);
}
inline void mbar_arrive(uint64_t* bar) {
  MockBar& b = mock_bar(bar);
  if (++b.arrived > b.count) mock_fail("mbarrier: more arrivals than set");
  mock_bar_check(b);
}
// arrive, announcing `bytes` of copies for the phase
inline void mbar_expect(uint64_t* bar, uint32_t bytes) {
  mock_bar(bar).pending += bytes;
  mbar_arrive(bar);
}
// a copy of `bytes` has landed
inline void mock_complete(uint64_t* bar, long long bytes) {
  MockBar& b = mock_bar(bar);
  if ((b.pending -= bytes) < 0)
    mock_fail("mbarrier: more bytes copied than announced");
  mock_bar_check(b);
}
// until the phase of that parity has completed (a fresh barrier's
// "previous" phase, parity 1, counts as completed)
inline void mbar_wait(uint64_t* bar, uint32_t parity = 0) {
  MockBar& b = mock_bar(bar);
  for (long spin = 0; b.done % 2 == static_cast<int>(parity); ++spin) {
    if (spin > 20000000) mock_fail("mbarrier: a phase never completed");
    mock_yield();
  }
}
inline void fence_proxy_async() {}

// a TMA box's destination: on an `align`-byte boundary of shared memory
inline void mock_box_aligned(const void* dst, uint32_t align = 128) {
  if (smem_addr(dst) % align)
    mock_fail("TMA box off its boundary in shared memory");
}

// the 128-byte swizzle of a shared-memory byte offset, as TMA writes a box
// and wgmma reads a tile: the 16-byte chunk (bits 4-6) XOR the 128-byte
// row within its 1 024 bytes (bits 7-9)
inline uint32_t mock_sw128(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}

// ---- the warpgroup ----------------------------------------------------

// a barrier of the calling thread's warpgroup (threads 128 w .. 128 w +
// 127 of the block), reused block after block; the other threads run on
// while it waits
inline int mock_wg_arrived[16];
inline unsigned mock_wg_gen[16];
inline void mock_wg_sync() {
  const int wg = threadIdx.x / 128;
  const int n = std::min(128, static_cast<int>(blockDim.x) - 128 * wg);
  const unsigned gen = mock_wg_gen[wg];
  if (++mock_wg_arrived[wg] == n) {
    mock_wg_arrived[wg] = 0;
    ++mock_wg_gen[wg];
    return;
  }
  for (long spin = 0; mock_wg_gen[wg] == gen; ++spin) {
    if (spin > 20000000) mock_fail("warpgroup: a thread never arrived");
    mock_yield();
  }
}
// .sync.aligned: every thread of the warpgroup executes it
template <int N>
inline void setmaxnreg_dec() {
  static_assert(N >= 24 && N <= 256 && N % 8 == 0, "setmaxnreg range");
  mock_wg_sync();
}
template <int N>
inline void setmaxnreg_inc() {
  static_assert(N >= 24 && N <= 256 && N % 8 == 0, "setmaxnreg range");
  mock_wg_sync();
}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
// every thread's wgmmas have computed when issued; the wait lines the
// warpgroup up, as the card's does
template <int N>
inline void wgmma_wait() { mock_wg_sync(); }
inline void wgmma_commit_wait() { mock_wg_sync(); }
template <class T, int N>
inline void reg_fence(T (&)[N]) {}

// named barriers (bar.sync / bar.arrive id, n): a barrier completes when
// n threads have arrived, a sync waits for that; each block starts with
// all sixteen clear, and one that a block left with arrivals fails
struct MockNamedBar {
  int arrived = 0;
  unsigned gen = 0;
};
inline MockNamedBar mock_named[16];
inline void mock_named_block_start() {
  for (MockNamedBar& b : mock_named) {
    if (b.arrived) mock_fail("named barrier: a block left it with arrivals");
    b = MockNamedBar{};
  }
}
inline const bool mock_named_hooked = (mock_on_block = mock_named_block_start,
                                       true);
inline void named_arrive(int id, int n) {
  MockNamedBar& b = mock_named[id];
  if (++b.arrived == n) {
    b.arrived = 0;
    ++b.gen;
  }
}
inline void named_sync(int id, int n) {
  MockNamedBar& b = mock_named[id];
  const unsigned gen = b.gen;
  named_arrive(id, n);
  for (long spin = 0; b.gen == gen; ++spin) {
    if (spin > 20000000) mock_fail("named barrier: never completed");
    mock_yield();
  }
}

// every lane's four 32-bit registers, once all lanes of the warp have
// given theirs (a register A operand of a wgmma: each warp's fragments)
inline void mock_warp_regs(const uint32_t* a, uint32_t (&all)[32][4]) {
  uint64_t o[32];
  for (int h = 0; h < 2; ++h) {
    mock_warp_exchange(a[2 * h] | static_cast<uint64_t>(a[2 * h + 1]) << 32,
                       o);
    for (int l = 0; l < 32; ++l) {
      all[l][2 * h] = static_cast<uint32_t>(o[l]);
      all[l][2 * h + 1] = static_cast<uint32_t>(o[l] >> 32);
    }
  }
}

// ---- wgmma descriptors ------------------------------------------------

// The byte offset in shared memory of element (mn, k) of a wgmma operand
// tile by its descriptor, as the card reads it: the start address, LBO
// and SBO (16-byte units, bits 0-13, 16-29, 32-45), the base offset (bits
// 49-51; none modelled but 0) and the layout type (bits 62-63).  esize
// bytes an element; the tile K-major (k contiguous) or MN-major.
//   type 0, no swizzle, K-major: 8 x 16-byte core matrices, 8-row groups
//     SBO apart, 16-byte column groups LBO apart;
//   type 1, 128-byte swizzle: rows of 128 bytes, swizzled by mock_sw128
//     on the address; K-major: 8-row groups SBO apart (LBO unused, k
//     within the 128-byte row); MN-major: 8-row groups along k SBO
//     apart, the next 128 bytes along mn LBO on.
inline uint32_t mock_desc_offset(uint64_t d, int mn, int k, int esize,
                                 bool mn_major) {
  const uint32_t start = static_cast<uint32_t>(d & 0x3FFF) << 4;
  const uint32_t lbo = static_cast<uint32_t>((d >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((d >> 32) & 0x3FFF) << 4;
  const int type = static_cast<int>(d >> 62);
  if ((d >> 49) & 7) mock_fail("wgmma descriptor: base offset not modelled");
  uint32_t off = 0;
  if (type == 0) {
    if (mn_major) mock_fail("wgmma descriptor: MN-major without swizzle");
    const int kb = k * esize;
    off = start + (mn / 8) * sbo + (kb / 16) * lbo + (mn % 8) * 16 + kb % 16;
  } else if (type == 1) {
    if ((start >> 7) & 7)
      mock_fail("wgmma descriptor: a swizzled tile off its 1 024-byte rows");
    if (mn_major) {
      const int mb = mn * esize;
      off = start + (mb / 128) * lbo + (k / 8) * sbo + (k % 8) * 128 +
            mb % 128;
    } else {
      const int kb = k * esize;
      if (start % 128 + kb >= 128)
        mock_fail("wgmma descriptor: k past the 128-byte swizzle row");
      off = start + (mn / 8) * sbo + (mn % 8) * 128 + kb;
    }
    off = mock_sw128(off);
  } else {
    mock_fail("wgmma descriptor: layout type not modelled");
  }
  if (off + esize > mock_dynamic_smem.size())
    mock_fail("wgmma operand past the end of shared memory");
  return off;
}
