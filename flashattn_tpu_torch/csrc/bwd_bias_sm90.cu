// K5 + K6 with an additive bias for Hopper (sm_90a): bwd_sm90_tile.cuh's
// single-pass TMA + wgmma backward with its bias stage, which writes dQ, dK,
// dV and, when the bias needs a gradient, dbias in one KV-major pass, as
// bwd_bias_sm90_kernel<D, DBIAS, CAP, SEG> (D 64 and 128, with and without
// dbias, the logit softcap and segment ids: 16 instantiations; a head dim
// below D that is a multiple of 8 runs in them, the TMA boxes reading zeros
// past it); and the C entry fa_bwd_bias_sm90.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd.py::_dkv_kernel (K5,
// :139) and ::_dq_kernel (K6, :234) on every backward with a bias
// (ops/flash_bwd.py::bias_bwd_route: bf16, D <= 128 -- causal, a window,
// q / kv offsets, segment ids, the softcap, decode-shaped or not, as the JAX
// package pairs a bias with them): the formulas, the masks (the KV tail,
// the Q tail, the band, the ids, dead rows) and the design are in
// bwd_sm90_tile.cuh. With the softcap, dbias is the gradient of the capped
// logit, dL, written before the cap's Jacobian multiplies it into dS
// (flashattn_tpu/ops/flash_bwd.py:300-304). dK / dV come per KV head (summed
// over its Hq / Hkv query heads inside the CTA); dQ is added into a zeroed
// f32 dQ; dbias is written on every (Q tile, KV tile) pair the kernel visits,
// 0 on its pairs that the band or the ids mask (the caller zero-fills it
// when the band, the ids or kv_valid_len < Nk leave pairs unvisited).
//
// What bounds it: at path A's shape (B4 H16 N2048 D128, non-causal) the five
// products are 344 GFLOP, 0.35 ms at 989 TFLOP/s: operations, with the mask
// arm's [4, 1, N, N] bias (67 MB); the learned arm's [4, 16, N, N] bias and
// its dbias are 1.07 GB each way, 0.64 ms at 3.35 TB/s: bytes. The mma.sync
// pair this replaces (K5 and K6 on mma.sync, 4 warps x 16 KV rows per CTA
// with 32-row Q steps between block barriers and one dependent scalar load
// of the bias per score, K6 recomputing S and dP: 7 products where a
// KV-major pass needs 5) ran it at 58 / 83 TFLOP/s. Grid (KV head,
// KV tile, batch): the head varies fastest, so the CTAs that share a
// [B, 1, N, N] bias tile stream it together and read it from HBM once. One
// thread issues the copies, the bias's too, so the producer keeps 24
// registers and the consumers K8's 240 (cp.async from 128 producer threads,
// as K1's bias route streams its bias, would need registers the consumers
// cannot spare: K8 already spills 56 B at 240).

#include "bwd_sm90_tile.cuh"

namespace {

template <int D, bool DBIAS, bool CAP, bool SEG>
__global__ void __launch_bounds__(BB_THREADS, 1)
    bwd_bias_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_bias, const BwdBiasParams p) {
  bwd_sm90_body<D, true, DBIAS, SEG, CAP>(tm_q, tm_k, tm_v, tm_do, &tm_bias, p);
}

template <int D, bool DBIAS, bool CAP, bool SEG>
cudaError_t bwd_bias_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                            const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                            const CUtensorMap& tm_bias, const BwdBiasParams& p, int hkv,
                            int batch, cudaStream_t stream) {
  auto kernel = bwd_bias_sm90_kernel<D, DBIAS, CAP, SEG>;
  constexpr int smem = BbSmem<D, true, SEG>::BYTES;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(hkv, (p.nk + BB_BLOCK_N - 1) / BB_BLOCK_N, batch);
  kernel<<<grid, BB_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, tm_bias, p);
  return cudaGetLastError();
}

template <int D, bool DBIAS, bool CAP>
cudaError_t bwd_bias_seg(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                         const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                         const CUtensorMap& tm_bias, const BwdBiasParams& p, int hkv, int batch,
                         cudaStream_t s) {
  return p.seg_q != nullptr
             ? bwd_bias_launch<D, DBIAS, CAP, true>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, hkv,
                                                     batch, s)
             : bwd_bias_launch<D, DBIAS, CAP, false>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, hkv,
                                                      batch, s);
}

template <int D>
cudaError_t bwd_bias_dispatch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                              const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                              const CUtensorMap& tm_bias, const BwdBiasParams& p, bool dbias,
                              bool cap, int hkv, int batch, cudaStream_t s) {
  if (dbias && cap) {
    return bwd_bias_seg<D, true, true>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, hkv, batch, s);
  }
  if (dbias) {
    return bwd_bias_seg<D, true, false>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, hkv, batch, s);
  }
  if (cap) {
    return bwd_bias_seg<D, false, true>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, hkv, batch, s);
  }
  return bwd_bias_seg<D, false, false>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, hkv, batch, s);
}

// The bias's TMA map: an f32 [B|1, H|1, Nq|1, Nk] tensor read through its
// (batch, head, row) strides in elements, a stride of 0 marking a broadcast
// dim, which becomes a dim of extent 1 (its coordinate always 0); the column
// extent is kv_valid_len, so columns past it and rows past Nq read zeros.
// Boxes of 32 columns x `rows` rows with the 128-byte swizzle.
bool make_bias_map(CUtensorMap* map, const void* bias, int batch, int heads, int nq, int ncols,
                   int64_t sb, int64_t sh, int64_t sn, int rows) {
  auto extent = [](int64_t s, int n) { return static_cast<cuuint64_t>(s ? n : 1); };
  auto bytes = [](int64_t s) { return static_cast<cuuint64_t>(s ? s * 4 : 16); };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(ncols), extent(sn, nq), extent(sh, heads),
                              extent(sb, batch)};
  const cuuint64_t strides[3] = {bytes(sn), bytes(sh), bytes(sb)};
  const cuuint32_t box[4] = {BB_BIAS_BOX, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(bias), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// K5 + K6 with a bias: dQ, dK, dV (and dbias) of attention with an additive
// f32 bias. q / dout [B, Hq, Nq, D] and k / v [B, Hkv, Nk, D] bf16, unit
// stride on D, the given (batch, head, seq) strides in elements (multiples
// of 8, nonzero on dims of extent > 1; 16-byte-aligned bases: TMA's); lse
// (natural log, from the forward) and delta [B, Hq, nq_pad] f32 contiguous,
// nq_pad a multiple of 64 >= Nq (the rows past Nq are read and not used),
// 16-byte aligned; bias [B|1, Hq|1, Nq|1, Nk] f32, unit column stride,
// (batch, head, row) strides in elements, 0 on broadcast dims, multiples of
// 4, 16-byte-aligned base; dq [B, Hq, Nq, D] f32 contiguous, zeroed (added
// to), 16-byte aligned; dk / dv [B, Hkv, Nk, D] f32 contiguous, written
// (summed over each KV head's query heads), 8-byte aligned; dbias null, or
// [B, Hq, Nq, Nk] f32 contiguous, written on every (64-row Q tile, 128-row KV
// tile) pair that the band, the ids and kv_valid_len leave (zero it first
// otherwise); causal, the window (wl, wr), the offsets (q_off, kv_off) and
// the segment ids (seg_q, seg_kv, q_range, kv_range at 64-row Q tiles and
// 128-key KV tiles, all four or none, q_tiles = ceil(Nq / 64)) as in
// fa_bwd_split_sm90 (flash_bwd_split_sm90.cu); softcap > 0 the forward's
// logit cap (dbias then the gradient of the capped logit), 0 none. Requires
// 8 <= D <= 128 with D % 8 == 0, Hq % Hkv == 0, Nq, Nk >= 1, 0 <=
// kv_valid_len <= Nk, B <= 65535.
// Returns a cudaError_t (0: success; cudaErrorInvalidValue for arguments it
// does not take, cudaErrorNotSupported when cuTensorMapEncodeTiled is
// missing or refuses a tensor map).
int fa_bwd_bias_sm90(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* bias, void* dq, void* dk,
                     void* dv, void* dbias, const void* seg_q, const void* seg_kv,
                     const void* q_range, const void* kv_range, int batch, int hq, int hkv,
                     int nq, int nk, int d, int kv_valid_len, int causal, int wl, int wr,
                     int q_off, int kv_off, int nq_pad, float scale, float softcap,
                     int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh,
                     int64_t k_sn, int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t do_sb,
                     int64_t do_sh, int64_t do_sn, int64_t bias_sb, int64_t bias_sh,
                     int64_t bias_sn, void* stream) {
  // The K/V and bias maps' key extent (at least 1: a map has no empty dim;
  // with kv_valid_len 0 no tile is loaded).
  const int nkv = kv_valid_len > 0 ? kv_valid_len : 1;
  const bool seg = seg_q != nullptr;
  if (d < 8 || d > 128 || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq % hkv != 0 || nq < 1 || nk < 1 || (nk + BB_BLOCK_N - 1) / BB_BLOCK_N > 65535 ||
      kv_valid_len < 0 || kv_valid_len > nk || nq_pad < nq || nq_pad % BB_BLOCK_M ||
      !(softcap >= 0.f) || bias == nullptr || !aligned(q, 16) || !aligned(k, 16) ||
      !aligned(v, 16) ||
      !aligned(dout, 16) || !aligned(lse, 16) || !aligned(delta, 16) || !aligned(bias, 16) ||
      !aligned(dq, 16) || !aligned(dk, 8) || !aligned(dv, 8) || !aligned(dbias, 4) ||
      !tma_strides(q_sb, batch, q_sh, hq, q_sn, nq) ||
      !tma_strides(k_sb, batch, k_sh, hkv, k_sn, nkv) ||
      !tma_strides(v_sb, batch, v_sh, hkv, v_sn, nkv) ||
      !tma_strides(do_sb, batch, do_sh, hq, do_sn, nq) || bias_sb % 4 || bias_sh % 4 ||
      bias_sn % 4 || bias_sb < 0 || bias_sh < 0 || bias_sn < 0 ||
      seg != (seg_kv != nullptr) || seg != (q_range != nullptr) ||
      seg != (kv_range != nullptr) ||
      (seg && (!aligned(seg_q, 16) || !aligned(seg_kv, 4) || !aligned(q_range, 8) ||
               !aligned(kv_range, 8)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int bias_rows = bias_sn ? BB_BLOCK_M : 1;
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  alignas(64) CUtensorMap tm_do;
  alignas(64) CUtensorMap tm_bias;
  if (!make_bhnd_map(&tm_q, q, batch, hq, nq, d, q_sb, q_sh, q_sn, BB_BLOCK_M) ||
      !make_bhnd_map(&tm_k, k, batch, hkv, nkv, d, k_sb, k_sh, k_sn, BB_BLOCK_N) ||
      !make_bhnd_map(&tm_v, v, batch, hkv, nkv, d, v_sb, v_sh, v_sn, BB_BLOCK_N) ||
      !make_bhnd_map(&tm_do, dout, batch, hq, nq, d, do_sb, do_sh, do_sn, BB_BLOCK_M) ||
      !make_bias_map(&tm_bias, bias, batch, hq, nq, nkv, bias_sb, bias_sh, bias_sn, bias_rows)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  BwdBiasParams p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.dbias = static_cast<float*>(dbias);
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nq_pad = nq_pad;
  p.nk = nk;
  p.kv_valid_len = kv_valid_len;
  p.d = d;
  band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_off) - kv_off);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_range = static_cast<const int2*>(q_range);
  p.kv_range = static_cast<const int2*>(kv_range);
  p.q_tiles = (nq + BB_BLOCK_M - 1) / BB_BLOCK_M;
  p.kv_tiles = (kv_valid_len + BB_BLOCK_N - 1) / BB_BLOCK_N;
  p.bias_rows = bias_rows;
  p.bias_b = bias_sb != 0;
  p.bias_h = bias_sh != 0;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  const bool cap = softcap > 0.f;
  p.cap_scale = cap ? scale / softcap : 0.f;
  p.cap_log2 = softcap * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool db = dbias != nullptr;
  const cudaError_t e =
      d <= 64 ? bwd_bias_dispatch<64>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, db, cap, hkv, batch, s)
              : bwd_bias_dispatch<128>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, db, cap, hkv, batch,
                                       s);
  return static_cast<int>(e);
}

}  // extern "C"
