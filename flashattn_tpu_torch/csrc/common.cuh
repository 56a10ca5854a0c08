// Device helpers shared by the port's attention kernels (sm_90a):
// mma.sync m16n8k16 bf16 with f32 accumulation, ldmatrix, 16-byte tile
// loads into padded shared memory, and segment-id ranges for tile skipping.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                         a3 = (g+8, 2t+8..)
//   B (16x8, "col"):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16x8):             c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// so the C fragments of two neighbouring n-tiles are exactly the A fragment
// of one k-step, and a row-major [n][k] shared tile gives B by 32-bit loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

// K/V element types: the kv_dtype code of the C entries fa_fwd and fa_decode,
// and the template argument KV of the K1 kernels.
enum : int { KV_BF16 = 0, KV_INT8 = 1, KV_FP8 = 2 };

template <int KV>
struct KvElem {
  using type = __nv_bfloat16;
};
template <>
struct KvElem<KV_INT8> {
  using type = int8_t;
};
template <>
struct KvElem<KV_FP8> {
  using type = __nv_fp8_storage_t;  // e4m3 bits
};

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// ops/oracle.py DEFAULT_MASK_VALUE: -0.7 * float32 max, finite so that a
// fully masked tile never computes -inf - (-inf).
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
// An unbounded side of the causal / window band (the kernels' lo, hi).
constexpr int NO_BOUND = 1 << 30;

// The band of flashattn_tpu/ops/flash_fwd.py::_range_predicates as (lo, hi),
// in the tensors' local positions: row i sees column j iff i - lo <= j <= i +
// hi. A negative window bound is no bound on that side; causal makes the
// right bound 0, whatever wr is. The JAX masks compare absolute positions,
// q_offset + i and kv_offset + j: a chunk pair at delta = q_offset -
// kv_offset shifts each bound that exists, hi + delta and lo - delta, and a
// side without one keeps NO_BOUND. A shifted bound may be negative (a band
// that misses the diagonal, or whole rows or KV tiles); it is clamped to
// [-NO_BOUND, NO_BOUND], which no position reaches.
inline void band_bounds(int causal, int wl, int wr, int* lo, int* hi, int64_t delta = 0) {
  auto shifted = [](int64_t b) {
    return static_cast<int>(b < -NO_BOUND ? -NO_BOUND : b > NO_BOUND ? NO_BOUND : b);
  };
  *lo = wl >= 0 && wl < NO_BOUND ? shifted(static_cast<int64_t>(wl) - delta) : NO_BOUND;
  *hi = causal ? shifted(delta)
               : wr >= 0 && wr < NO_BOUND ? shifted(static_cast<int64_t>(wr) + delta) : NO_BOUND;
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared by cp.async; src_bytes 0 zero-fills the 16 bytes
// and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices, transposed on load: lanes 8i..8i+7 address the rows
// of matrix i, and register i of every lane receives its piece of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows_valid` rows of `d` (a multiple of 8) bf16 from global memory into
// a ROWS x DP shared tile with row stride DP + 8, in 16-byte pieces; rows past
// rows_valid and columns past d are zero-filled and never read from global.
// The row stride DP + 8 elements ((DP/2 + 4) 32-bit words) puts the 8 rows
// that one fragment load or ldmatrix touches on distinct banks.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* g,
                                          int64_t row_stride, int rows_valid, int d) {
  constexpr int CHUNKS = DP / 8;
  constexpr int STRIDE = DP + 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid && c * 8 < d) {
      val = *reinterpret_cast<const uint4*>(g + r * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(smem + r * STRIDE + c * 8) = val;
  }
}

// Packed-sequence tile skipping (flashattn_tpu/ops/flash.py::_seg_block_flags):
// the (min, max) of the segment ids ids[0, n), identical in every lane of the
// calling warp. Every warp of a CTA computes it from the same ids, so a skip
// decided on it is uniform across the CTA. n == 0 gives an empty range.
__device__ __forceinline__ int2 warp_id_range(const int* ids, int n) {
  int lo = 0x7fffffff;
  int hi = -0x7fffffff - 1;
  for (int i = threadIdx.x % 32; i < n; i += 32) {
    lo = min(lo, ids[i]);
    hi = max(hi, ids[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// Two tiles can hold a matching pair only if their id ranges intersect; a
// disjoint pair of ranges proves that none does (exact for any ids).
__device__ __forceinline__ bool ranges_meet(int2 a, int2 b) {
  return a.x <= b.y && b.x <= a.y;
}

// Raise a kernel's dynamic shared-memory limit when it needs more than 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fa
