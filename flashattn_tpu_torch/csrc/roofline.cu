// K10: the tensor-core peak probe for Hopper (sm_90a), bf16 mma.sync.
//
// Replaces the TPU kernel flashattn_tpu/ops/roofline.py::_roofline_kernel
// (:28): N_CHAINS = 4 independent chains, each `iters` times
// c <- (a + 1e-30 c) @ b over size x size bf16 a, b with f32 products, and
// the sum of the chains cast to bf16. The 1e-30 c term is there only so that
// nothing is hoisted out of the loop: it never changes a bf16 a of unit
// scale, so every chain ends at a @ b and the output is the sum of N_CHAINS
// copies of it. Taken literally, the recurrence would tie each output tile
// to a whole row panel of c, a grid-wide sync every iteration on Hopper.
// Here the feedback stays inside each CTA's own tile instead:
//
//   c <- a @ b + 1e-30 c
//
// with c in registers (the accumulator each mma.sync starts from), which is
// the same number (1e-30 c is below half an ulp of a @ b) and the same
// dependency chain: every iteration's products wait on the last one's.
// mma_bf16_16816 is `asm volatile`, so the compiler can neither hoist nor
// merge the chains' products either; chip_smoke.py counts the HMMA
// instructions of this kernel in the built library's SASS.
//
//   * One CTA per 32 x 32 tile of the output (256 CTAs at size 512, up to 3
//     per SM), 4 warps of 16 x 16 each. The CTA's 32-row panel of a and
//     32-column panel of b are loaded once into shared memory (74 KB at size
//     512); every iteration then reads its fragments from there, so the
//     loop issues tensor-core work and shared-memory loads only: 8 mma.sync
//     (4 chains x 2 n-tiles) per k-step on one A fragment and one
//     ldmatrix.x4 of B.
//
// What bounds it: the tensor cores, by design -- 2 size^3 iters N_CHAINS
// FLOP on 3 size^2 x 2 bytes. What it measures is the rate mma.sync reaches
// from shared-memory operands, the ceiling of the port's mma.sync kernels;
// wgmma, which alone reaches the card's datasheet rate, is not used.

#include "common.cuh"

namespace {

using namespace fa;

constexpr int N_CHAINS = 4;      // ops/roofline.py N_CHAINS
constexpr int RT_TILE = 32;      // output rows and columns per CTA
constexpr int RT_THREADS = 128;  // 4 warps of 16 x 16
constexpr int RT_B_STRIDE = RT_TILE + 8;

size_t roofline_smem_bytes(int size) {
  return (static_cast<size_t>(RT_TILE) * (size + 8) + static_cast<size_t>(size) * RT_B_STRIDE) *
         sizeof(__nv_bfloat16);
}

template <int CHAINS>
__global__ void __launch_bounds__(RT_THREADS)
    roofline_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                    __nv_bfloat16* __restrict__ out, int size, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int a_stride = size + 8;
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [32][size + 8]
  __nv_bfloat16* s_b = s_a + RT_TILE * a_stride;                     // [size][40]
  const int m0 = blockIdx.y * RT_TILE;
  const int n0 = blockIdx.x * RT_TILE;
  for (int idx = threadIdx.x; idx < RT_TILE * (size / 8); idx += RT_THREADS) {
    const int r = idx / (size / 8);
    const int c = idx % (size / 8) * 8;
    *reinterpret_cast<uint4*>(s_a + r * a_stride + c) =
        *reinterpret_cast<const uint4*>(a + static_cast<int64_t>(m0 + r) * size + c);
  }
  for (int idx = threadIdx.x; idx < size * (RT_TILE / 8); idx += RT_THREADS) {
    const int r = idx / (RT_TILE / 8);
    const int c = idx % (RT_TILE / 8) * 8;
    *reinterpret_cast<uint4*>(s_b + r * RT_B_STRIDE + c) =
        *reinterpret_cast<const uint4*>(b + static_cast<int64_t>(r) * size + n0 + c);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / 2;  // rows wm * 16 ...
  const int wn = warp % 2;  // columns wn * 16 ...
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (lane >> 4) * 8;
  const __nv_bfloat16* a_w = s_a + (wm * 16 + g) * a_stride + 2 * t;
  const __nv_bfloat16* b_w = s_b + b_row * RT_B_STRIDE + wn * 16 + b_col;

  float c[CHAINS][2][4];
#pragma unroll
  for (int ch = 0; ch < CHAINS; ++ch) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[ch][0][e] = c[ch][1][e] = 0.f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ch = 0; ch < CHAINS; ++ch) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[ch][0][e] *= 1e-30f;  // the feedback: this iteration starts from 1e-30 c
        c[ch][1][e] *= 1e-30f;
      }
    }
#pragma unroll 4
    for (int ks = 0; ks < size / 16; ++ks) {
      const __nv_bfloat16* ar = a_w + ks * 16;
      const uint32_t af[4] = {ld_b32(ar), ld_b32(ar + 8 * a_stride), ld_b32(ar + 8),
                              ld_b32(ar + 8 * a_stride + 8)};
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b_w + ks * 16 * RT_B_STRIDE);
#pragma unroll
      for (int ch = 0; ch < CHAINS; ++ch) {
        mma_bf16_16816(c[ch][0], af, bf[0], bf[1]);
        mma_bf16_16816(c[ch][1], af, bf[2], bf[3]);
      }
    }
  }

  // The chains' sum in the JAX order, ((c0 + c1) + c2) + c3, as bf16.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x0 = c[0][j][2 * r];
      float x1 = c[0][j][2 * r + 1];
#pragma unroll
      for (int ch = 1; ch < CHAINS; ++ch) {
        x0 += c[ch][j][2 * r];
        x1 += c[ch][j][2 * r + 1];
      }
      const int64_t idx = static_cast<int64_t>(m0 + wm * 16 + g + 8 * r) * size + n0 + wn * 16 +
                          j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(out + idx) = pack_bf16(x0, x1);
    }
  }
}

}  // namespace

extern "C" {

// out [size, size] bf16 = the sum over N_CHAINS chains of `iters` chained
// products of a, b [size, size] bf16 (row-major, contiguous). Requires
// size % 64 == 0, 64 <= size <= 1536 (the panels fit shared memory) and
// iters >= 1. Returns a cudaError_t (0 on success).
int fa_roofline_bf16(const void* a, const void* b, void* out, int size, int iters, void* stream) {
  if (size < 64 || size > 1536 || size % 64 || iters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = roofline_smem_bytes(size);
  const cudaError_t e = allow_smem(roofline_kernel<N_CHAINS>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(size / RT_TILE, size / RT_TILE);
  roofline_kernel<N_CHAINS><<<grid, RT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(out), size, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
