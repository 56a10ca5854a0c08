// K9: the tiled GEMM probe for Hopper (sm_90a), bf16 tensor cores.
//
// Replaces the TPU kernel flashattn_tpu/ops/gemm.py::_matmul_kernel (:22):
// C = A B for A [M, K] and B [K, N] bf16, row-major and contiguous, with f32
// accumulation and C in bf16 or f32 (the probe's `out_dtype`). The TPU kernel
// walks K as a sequential grid axis and carries the f32 sum in a VMEM
// scratch between grid steps, with (bm, bn, bk) blocks of 512; here CTAs run
// in parallel in no order, so one CTA owns a 128 x 128 tile of C and loops
// over K in 32-deep steps itself, its sum in registers. The caller's block
// sizes are validated as the JAX function validates them (ops/gemm.py) but
// do not shape this tile: M and N are multiples of 128 and K of 32 whenever
// they pass.
//
//   * 8 warps, 2 x 4: each owns 64 rows x 32 columns of C, 4 x 4 mma.sync
//     m16n8k16 tiles (64 f32 accumulators a thread).
//   * A's 128 x 32 and B's 32 x 128 tiles go through shared memory with rows
//     padded by 8 bf16, so the 8 rows of a fragment load or ldmatrix fall on
//     distinct banks; A's fragments come by 32-bit loads, B's transposed by
//     ldmatrix (B is row-major [k][n], as V is in fwd_tile.cuh).
//
// What bounds it: at 4096^3 the product is 2 M N K = 137 GFLOP over 96 MB,
// ~1400 FLOP per byte, far above the H100's ~295: operations. This simple
// kernel loads each tile synchronously behind a barrier and issues mma.sync,
// not wgmma, so it stays below the mma.sync ceiling that K10 (roofline.cu)
// measures; a TMA ring with wgmma warpgroups is for a later PR.

#include "common.cuh"

namespace {

using namespace fa;

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;
constexpr int A_STRIDE = GEMM_BK + 8;  // shared row strides (bf16)
constexpr int B_STRIDE = GEMM_BN + 8;

template <bool OUT_F32>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                void* __restrict__ out, int n, int k) {
  __shared__ __align__(16) __nv_bfloat16 s_a[GEMM_BM * A_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 s_b[GEMM_BK * B_STRIDE];
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / 4;  // rows wm * 64 ...
  const int wn = warp % 4;  // columns wn * 32 ...
  // ldmatrix.trans lane -> (row, col) of the 16x16 B block it addresses.
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (lane >> 4) * 8;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;
    }
  }

  for (int k0 = 0; k0 < k; k0 += GEMM_BK) {
    __syncthreads();  // the previous tiles are consumed
    for (int idx = threadIdx.x; idx < GEMM_BM * GEMM_BK / 8; idx += GEMM_THREADS) {
      const int r = idx / (GEMM_BK / 8);
      const int c = idx % (GEMM_BK / 8) * 8;
      *reinterpret_cast<uint4*>(s_a + r * A_STRIDE + c) =
          *reinterpret_cast<const uint4*>(a + static_cast<int64_t>(m0 + r) * k + k0 + c);
    }
    for (int idx = threadIdx.x; idx < GEMM_BK * GEMM_BN / 8; idx += GEMM_THREADS) {
      const int r = idx / (GEMM_BN / 8);
      const int c = idx % (GEMM_BN / 8) * 8;
      *reinterpret_cast<uint4*>(s_b + r * B_STRIDE + c) =
          *reinterpret_cast<const uint4*>(b + static_cast<int64_t>(k0 + r) * n + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* ar = s_a + (wm * 64 + mi * 16 + g) * A_STRIDE + kk * 16 + 2 * t;
        af[mi][0] = ld_b32(ar);
        af[mi][1] = ld_b32(ar + 8 * A_STRIDE);
        af[mi][2] = ld_b32(ar + 8);
        af[mi][3] = ld_b32(ar + 8 * A_STRIDE + 8);
      }
      uint32_t bf[2][4];
#pragma unroll
      for (int dt = 0; dt < 2; ++dt) {
        ldmatrix_x4_trans(bf[dt], s_b + (kk * 16 + b_row) * B_STRIDE + wn * 32 + dt * 16 + b_col);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          mma_bf16_16816(acc[mi][nj], af[mi], bf[nj / 2][(nj % 2) * 2], bf[nj / 2][(nj % 2) * 2 + 1]);
        }
      }
    }
  }

  // C rows g and g + 8 of each 16-row tile, columns 2t, 2t + 1 of each n-tile.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t idx = static_cast<int64_t>(m0 + wm * 64 + mi * 16 + g + 8 * r) * n + n0 +
                            wn * 32 + nj * 8 + 2 * t;
        if constexpr (OUT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
              make_float2(acc[mi][nj][2 * r], acc[mi][nj][2 * r + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + idx) =
              pack_bf16(acc[mi][nj][2 * r], acc[mi][nj][2 * r + 1]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// out [M, N] = a [M, K] @ b [K, N]: a, b bf16 row-major contiguous; out f32
// (out_f32 != 0) or bf16, contiguous. Requires M, N multiples of 128 and K
// of 32, each positive, M / 128 <= 65535. Returns a cudaError_t (0 on success).
int fa_gemm_bf16(const void* a, const void* b, void* out, int m, int n, int k, int out_f32,
                 void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % GEMM_BM || n % GEMM_BN || k % GEMM_BK ||
      m / GEMM_BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n / GEMM_BN, m / GEMM_BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  if (out_f32) {
    gemm_kernel<true><<<grid, GEMM_THREADS, 0, s>>>(pa, pb, out, n, k);
  } else {
    gemm_kernel<false><<<grid, GEMM_THREADS, 0, s>>>(pa, pb, out, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
