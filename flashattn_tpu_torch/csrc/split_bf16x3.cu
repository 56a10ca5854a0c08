// The f32 routes' operand split (sm_90a): an f32 [B, H, N, D] tensor as three
// bf16 pieces x = x0 + x1 + x2 (x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x -
// x0 - x1), each rounded to nearest even), the form in which K1's f32 route
// (flash_fwd_f32.cu) and the f32 backward (flash_bwd_f32.cu) TMA-load their
// operands: every f32 product there is the six bf16 products a0 b0 + a0 b1 +
// a1 b0 + a0 b2 + a1 b1 + a2 b0 summed in f32, the bf16 multipass that the
// TPU's MXU runs for the JAX kernels' Precision.HIGHEST
// (flashattn_tpu/ops/flash_fwd.py:232-236).
//
// Replaces no TPU kernel: on the TPU the split happens inside the matrix
// unit. It exists so that the attention bodies read bf16 tiles by TMA and
// multiply them by bf16 wgmma, whose transpose bits the 32-bit types lack.
// It has no C entry of its own: the f32 routes' C entries call
// fa::split_bf16x3 (split_bf16x3.cuh) before their attention kernel. Its
// plain version is ops/f32_split.py::split_reference, bit for bit: the
// differences x - x0 and x - x0 - x1 are exact in f32, and both round by
// __float2bfloat16_rn (no flush of subnormals).
//
// What bounds it: bytes. Each f32 element is read once (4 bytes) and written
// as three bf16 (6 bytes, 8 past D in a box of 64 or 128 columns): at the f32
// LM's Q, K and V (B1 Hq16 Hkv8 N2048 D128) 33.6 MB read and 50.3 MB written,
// 0.025 ms at 3.35 TB/s. One thread takes 8 columns of a row -- two 16-byte
// loads (4-byte ones where the view's alignment or D forbids them) and three
// 16-byte stores, neighbouring threads on neighbouring addresses -- so the
// copy runs at the memory's rate.
//
// Layout of the output: [3, B, H, N, DB] bf16 contiguous (DB the D box, 64
// or 128), piece p of batch b being batch p * B + b of a [3B, H, N, DB]
// tensor, the 4-D TMA maps of the attention bodies; columns D..DB-1 are
// zeros. One launch splits up to four operands (the f32 routes' C entries
// split Q, K and V, or Q, K, V and dO, before their attention kernel): each
// block finds its operand by its index.

#include <cuda_bf16.h>

#include "split_bf16x3.cuh"

namespace {

constexpr int SPLIT_THREADS = 256;

struct SplitTensor {
  const float* x;
  __nv_bfloat16* out;
  int64_t sb, sh, sn;  // x's (batch, head, seq) strides in elements
  int64_t chunks;      // B * H * N * (db / 8)
  int64_t piece;       // B * H * N * db: elements between two pieces
  int64_t block0;      // the operand's first block
  int heads, n, d;
  int vec;  // x 16-byte aligned with strides that are multiples of 4: 16-byte loads
};

struct SplitParams {
  SplitTensor t[fa::SPLIT_MAX_TENSORS];
  int count, db;
};

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

__global__ void __launch_bounds__(SPLIT_THREADS) split_bf16x3_kernel(const SplitParams p) {
  int k = 0;
  while (k + 1 < p.count && blockIdx.x >= p.t[k + 1].block0) ++k;
  const SplitTensor& a = p.t[k];
  const int64_t i = (blockIdx.x - a.block0) * SPLIT_THREADS + threadIdx.x;
  if (i >= a.chunks) return;
  const int cpr = p.db / 8;  // 8-column chunks per row
  const int c = static_cast<int>(i % cpr);
  const int64_t row = i / cpr;  // (b, h, n) in order
  const int n = static_cast<int>(row % a.n);
  const int64_t bh = row / a.n;
  const int h = static_cast<int>(bh % a.heads);
  const int64_t b = bh / a.heads;
  const float* src = a.x + b * a.sb + h * a.sh + n * a.sn + 8 * c;
  float x[8];
  if (a.vec && 8 * c + 8 <= a.d) {
    const float4 lo = reinterpret_cast<const float4*>(src)[0];
    const float4 hi = reinterpret_cast<const float4*>(src)[1];
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 8 * c + e < a.d ? src[e] : 0.f;
  }
  uint32_t w[3][4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    __nv_bfloat16 pc[3][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float r = x[e + j];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        pc[q][j] = __float2bfloat16_rn(r);
        r -= __bfloat162float(pc[q][j]);  // exact in f32
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) w[q][e / 2] = pack2(pc[q][0], pc[q][1]);
  }
  __nv_bfloat16* dst = a.out + row * p.db + 8 * c;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    *reinterpret_cast<uint4*>(dst + q * a.piece) = make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
  }
}

}  // namespace

namespace fa {

cudaError_t split_bf16x3(const SplitArg* args, int count, int db, cudaStream_t stream) {
  if (count < 1 || count > SPLIT_MAX_TENSORS || db < 8 || db % 8) return cudaErrorInvalidValue;
  SplitParams p;
  p.count = count;
  p.db = db;
  int64_t blocks = 0;
  for (int k = 0; k < count; ++k) {
    const SplitArg& a = args[k];
    SplitTensor& t = p.t[k];
    if (a.batch < 1 || a.heads < 1 || a.n < 1 || a.d < 1 || a.d > db ||
        reinterpret_cast<uintptr_t>(a.out) % 16) {
      return cudaErrorInvalidValue;
    }
    t.x = static_cast<const float*>(a.x);
    t.out = static_cast<__nv_bfloat16*>(a.out);
    t.sb = a.sb;
    t.sh = a.sh;
    t.sn = a.sn;
    t.heads = a.heads;
    t.n = a.n;
    t.d = a.d;
    t.vec = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 && (a.sb | a.sh | a.sn) % 4 == 0;
    const int64_t rows = static_cast<int64_t>(a.batch) * a.heads * a.n;
    t.piece = rows * db;
    t.chunks = rows * (db / 8);
    t.block0 = blocks;
    blocks += (t.chunks + SPLIT_THREADS - 1) / SPLIT_THREADS;
  }
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  split_bf16x3_kernel<<<static_cast<unsigned>(blocks), SPLIT_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fa
