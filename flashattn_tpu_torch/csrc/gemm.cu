// K9: the GEMM probe for Hopper (sm_90a), TMA loads and wgmma.
//
// Replaces the TPU kernel flashattn_tpu/ops/gemm.py::_matmul_kernel (:22):
// C = A B for A [M, K] and B [K, N] bf16, row-major and contiguous, with f32
// accumulation and C in bf16 or f32 (the probe's `out_dtype`). The TPU kernel
// walks K as a sequential grid axis and carries the f32 sum in a VMEM scratch
// between grid steps, with (bm, bn, bk) blocks of 512; here CTAs run in
// parallel in no order, so one CTA owns a 128 x 256 tile of C and loops over K
// in 64-deep steps itself, its sum in registers. The caller's block sizes are
// validated as the JAX function validates them (ops/gemm.py) but do not shape
// this tile: M, N and K are multiples of 128 whenever they pass, and a
// 256-wide tile that hangs over N (N = 128 mod 256) reads zeros there (TMA's
// out-of-bounds fill) and stores only the columns below N.
//
// What bounds it: at 4096^3 the product is 2 M N K = 137 GFLOP over 96 MB,
// ~1400 FLOP per byte, far above the H100's ~295: operations (0.139 ms at 989
// TFLOP/s). So the design feeds the tensor cores at their wgmma rate:
//
//   * A 4-stage ring of (A 128 x 64, B 64 x 256) bf16 tiles in dynamic shared
//     memory with the 128-byte swizzle, filled by TMA (cp.async.bulk.tensor.2d:
//     A as one 64 x 128 box, B as four 64 x 64 boxes, 64 columns being the
//     128 bytes the swizzle spans). Loads complete on "full" mbarriers (expect
//     the stage's bytes); consumers release a stage through its "empty"
//     mbarrier once the wgmma that read it have retired.
//   * Warp specialisation: warpgroup 0 is the producer (one thread issues the
//     TMA loads; setmaxnreg gives its registers away), warpgroups 1 and 2 are
//     consumers, each owning 64 rows x 256 columns of C in 128 f32
//     registers a thread and issuing wgmma.mma_async m64n256k16 (4 per
//     64-deep step) with wgmma.fence / commit_group / wait_group, keeping
//     one step's products in flight while the next stage is waited on.
//   * A is K-major (row-major [M, K]); B, row-major [K, N], is N-major, which
//     wgmma takes for 16-bit types through the descriptor's transpose bit.
//     Both descriptors use the 128-byte swizzle of the TMA boxes: A's stride
//     byte offset 1024 (8 rows of 128 bytes), its k-step +32 bytes; B's
//     leading byte offset 8192 (the next 64-column box), stride byte offset
//     1024 (the next 8 k rows), its k-step +2048 bytes (16 rows).
//   * Epilogue: registers straight to global memory, bf16 or f32.
//
// The tensor maps are built on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint so the library links no libcuda, and passed
// as __grid_constant__ kernel parameters.
//
// f32 inputs (fa_gemm_f32; the JAX probe takes any dtype, its dot at
// Precision.HIGHEST on f32): each f32 product is the six bf16 products a0 b0
// + a0 b1 + a1 b0 + a0 b2 + a1 b1 + a2 b0 of the pieces x = x0 + x1 + x2
// (ops/f32_split.py), the small ones first, as K1's f32 route takes them.
// The C entry first splits a and b by one launch of split_bf16x3.cu: a
// contiguous [M, K] with K % 128 == 0 is the [1, 1, M K / 128, 128] tensor
// whose pieces [3, M K] are three row-major [M, K] bf16 matrices, so the
// split needs no 2-D form; one tensor map then covers the three as [3M, K]
// (b's as [3K, N]). Three pieces triple a stage (48 KB -> 144 KB at the bf16
// tile), so the f32 kernel takes 128 x 128 tiles of C and 2 stages of 96 KB
// (197,664 B), each consumer warpgroup 64 rows x 128 columns (64 f32
// registers) by wgmma m64n128k16, 24 a 64-deep step. Bound at 4096^3: 137.4
// GFLOP of f32 products at 989 / 6 = 165 TFLOP/s, 0.833 ms.

#include "sm90.cuh"
#include "split_bf16x3.cuh"

namespace {

using namespace fa;

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 256;
constexpr int GEMM_BK = 64;
constexpr int GEMM_STAGES = 4;
constexpr int GEMM_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int A_TILE = GEMM_BM * GEMM_BK * 2;  // bytes
constexpr int B_BOX = GEMM_BK * 64 * 2;        // one 64 x 64 box of B
constexpr int B_TILE = GEMM_BK * GEMM_BN * 2;
constexpr int STAGE_BYTES = A_TILE + B_TILE;
constexpr int GEMM_SMEM = 1024 + GEMM_STAGES * STAGE_BYTES + 2 * GEMM_STAGES * 8;

// D (64 x 256, f32) += A (64 x 16, K-major) B (16 x 256, N-major: trans-b 1).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <bool OUT_F32>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_b, void* __restrict__ out, int n,
                      int k) {
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GEMM_STAGES * STAGE_BYTES);
  uint64_t* empty = full + GEMM_STAGES;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;
  const int k_tiles = k / GEMM_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % GEMM_STAGES;
        mbar_wait(&empty[s], ((kt / GEMM_STAGES) & 1) ^ 1);  // round 0 passes at once
        unsigned char* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(st, &tm_a, &full[s], kt * GEMM_BK, m0);
#pragma unroll
        for (int j = 0; j < GEMM_BN / 64; ++j) {
          tma_load_2d(st + A_TILE + j * B_BOX, &tm_b, &full[s], n0 + 64 * j, kt * GEMM_BK);
        }
      }
    }
  } else {
    // Consumers: warpgroup 1 owns rows 0-63 of the tile, warpgroup 2 rows 64-127.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % GEMM_STAGES;
      mbar_wait(&full[s], (kt / GEMM_STAGES) & 1);
      const unsigned char* a_t = smem + s * STAGE_BYTES + half * 64 * 128;
      const unsigned char* b_t = smem + s * STAGE_BYTES + A_TILE;
      fence_regs(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
        wgmma_m64n256k16(d, smem_desc(a_t + kk * 32, 16, 1024),
                         smem_desc(b_t + kk * 16 * 128, B_BOX, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // The previous step's products have retired: release its stage.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(d);
      if (kt > 0 && tid == 0) mbar_arrive(&empty[(kt - 1) % GEMM_STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(d);

    // d[4j + (0, 1)]: row g, columns 8j + 2t + (0, 1); d[4j + (2, 3)]: row g + 8.
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int64_t row = m0 + half * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < GEMM_BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (n0 + 8 * j < n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int64_t idx = (row + 8 * r) * n + col;
          if constexpr (OUT_F32) {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
                make_float2(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
          } else {
            *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + idx) =
                pack_bf16(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
          }
        }
      }
    }
  }
}

// The f32 kernel (the header's notes): tiles of 128 x 128, 2 stages, each
// stage A's three pieces (128 x 64) then B's (64 x 128, two 64 x 64 boxes).
constexpr int GF_BN = 128;
constexpr int GF_STAGES = 2;
constexpr int GF_A_PIECE = GEMM_BM * GEMM_BK * 2;
constexpr int GF_B_PIECE = GEMM_BK * GF_BN * 2;
constexpr int GF_STAGE = 3 * (GF_A_PIECE + GF_B_PIECE);
constexpr int GF_SMEM = 1024 + GF_STAGES * GF_STAGE + 2 * GF_STAGES * 8;
static_assert(GF_SMEM <= 232448, "a block's shared memory on sm_90");

template <bool OUT_F32>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_f32_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b, void* __restrict__ out, int m,
                    int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GF_STAGES * GF_STAGE);
  uint64_t* empty = full + GF_STAGES;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GF_BN;
  const int k_tiles = k / GEMM_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GF_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % GF_STAGES;
        mbar_wait(&empty[s], ((kt / GF_STAGES) & 1) ^ 1);  // round 0 passes at once
        unsigned char* st = smem + s * GF_STAGE;
        mbar_expect_tx(&full[s], GF_STAGE);
#pragma unroll
        for (int pc = 0; pc < 3; ++pc) {
          tma_load_2d(st + pc * GF_A_PIECE, &tm_a, &full[s], kt * GEMM_BK, pc * m + m0);
#pragma unroll
          for (int j = 0; j < GF_BN / 64; ++j) {
            tma_load_2d(st + 3 * GF_A_PIECE + pc * GF_B_PIECE + j * B_BOX, &tm_b, &full[s],
                        n0 + 64 * j, pc * k + kt * GEMM_BK);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % GF_STAGES;
      mbar_wait(&full[s], (kt / GF_STAGES) & 1);
      const unsigned char* st = smem + s * GF_STAGE;
      fence_regs(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int x = 0; x < 6; ++x) {  // K9 f32 products
        const unsigned char* a_t = st + pair_a(x) * GF_A_PIECE + half * 64 * 128;
        const unsigned char* b_t = st + 3 * GF_A_PIECE + pair_b(x) * GF_B_PIECE;
#pragma unroll
        for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
          wgmma_ss_kn_m64n128k16(d, smem_desc(a_t + kk * 32, 16, 1024),
                                 smem_desc(b_t + kk * 16 * 128, B_BOX, 1024));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(d);
      if (kt > 0 && tid == 0) mbar_arrive(&empty[(kt - 1) % GF_STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(d);

    const int warp = tid / 32;
    const int lane = tid % 32;
    const int64_t row = m0 + half * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < GF_BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t idx = (row + 8 * r) * n + col;
        if constexpr (OUT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
              make_float2(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + idx) =
              pack_bf16(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// A 2-D bf16 row-major [rows, cols] tensor map with boxes of box_rows x 64
// columns (128 bytes, the 128-byte swizzle's span); out-of-bounds reads zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return make_map_bf16(map, ptr, 2, dims, strides, box);
}

}  // namespace

extern "C" {

// out [M, N] = a [M, K] @ b [K, N]: a, b bf16 row-major contiguous with
// 16-byte-aligned bases; out f32 (out_f32 != 0) or bf16, contiguous. Requires
// M, N and K positive multiples of 128 and M / 128 <= 65535. Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for a shape it does not
// take, cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or
// refuses a tensor map).
int fa_gemm_bf16(const void* a, const void* b, void* out, int m, int n, int k, int out_f32,
                 void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % 128 || n % 128 || k % 128 || m / GEMM_BM > 65535 ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  alignas(64) CUtensorMap tm_a;
  alignas(64) CUtensorMap tm_b;
  if (!make_map(&tm_a, a, m, k, GEMM_BM) || !make_map(&tm_b, b, k, n, GEMM_BK)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const dim3 grid((n + GEMM_BN - 1) / GEMM_BN, m / GEMM_BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = out_f32 ? gemm_wgmma_kernel<true> : gemm_wgmma_kernel<false>;
  const cudaError_t e = allow_smem(kernel, GEMM_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, GEMM_THREADS, GEMM_SMEM, s>>>(tm_a, tm_b, out, n, k);
  return static_cast<int>(cudaGetLastError());
}

// out [M, N] = a [M, K] @ b [K, N] for f32 a, b (row-major, contiguous),
// each f32 product as six bf16 products (the header's notes); out f32
// (out_f32 != 0) or bf16, contiguous. pieces: bf16 scratch of 3 (M K + K N)
// elements, 16-byte aligned, into which one launch of the split
// (split_bf16x3.cu) writes a's and b's pieces first. Requires M, N and K
// positive multiples of 128 and M / 128 <= 65535. Returns a cudaError_t (0
// on success; cudaErrorInvalidValue for arguments it does not take,
// cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or refuses a
// tensor map).
int fa_gemm_f32(const void* a, const void* b, void* out, void* pieces, int m, int n, int k,
                int out_f32, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % 128 || n % 128 || k % 128 || m / GEMM_BM > 65535 ||
      reinterpret_cast<uintptr_t>(pieces) % 16 || static_cast<int64_t>(m) * k / 128 > INT32_MAX ||
      static_cast<int64_t>(k) * n / 128 > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* ap = static_cast<__nv_bfloat16*>(pieces);
  __nv_bfloat16* bp = ap + 3LL * m * k;
  // Each matrix as rows of 128 elements: its pieces are three copies of its layout.
  const fa::SplitArg split[2] = {
      {a, ap, 1, 1, static_cast<int>(static_cast<int64_t>(m) * k / 128), 128, 0, 0, 128},
      {b, bp, 1, 1, static_cast<int>(static_cast<int64_t>(k) * n / 128), 128, 0, 0, 128}};
  cudaError_t e = fa::split_bf16x3(split, 2, 128, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  alignas(64) CUtensorMap tm_a;
  alignas(64) CUtensorMap tm_b;
  if (!make_map(&tm_a, ap, 3 * m, k, GEMM_BM) || !make_map(&tm_b, bp, 3 * k, n, GEMM_BK)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const dim3 grid(n / GF_BN, m / GEMM_BM);
  auto kernel = out_f32 ? gemm_f32_kernel<true> : gemm_f32_kernel<false>;
  e = allow_smem(kernel, GF_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, GEMM_THREADS, GF_SMEM, s>>>(tm_a, tm_b, out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
