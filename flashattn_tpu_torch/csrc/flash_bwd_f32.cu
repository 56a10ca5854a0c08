// The f32 backward: the C entry fa_bwd_f32 and the eight instantiations (D
// boxes 64 and 128, without and with segment ids, without and with the logit
// softcap) of bwd_f32_tile.cuh's body -- K3 on f32 inputs (neither option),
// and K5 + K6 without a bias on f32 inputs (either or both), as one body, as
// bwd_sm90_tile.cuh serves K3 and the split route in bf16. The band and the
// tails are runtime ints. What it replaces, what bounds it and its design are
// in bwd_f32_tile.cuh; the routes (ops/flash_bwd_fused.py::bwd and
// ops/flash_bwd.py::split_bwd on an f32 q, both through
// ops/flash_bwd.py::_f32_bwd_launch) are decided in Python.

#include "bwd_f32_tile.cuh"

namespace {

template <int DB, bool SEG, bool CAP>
cudaError_t bwd_f32_launch(const BwdF32Params& p, int batch, cudaStream_t stream) {
  auto kernel = bwd_f32_kernel<DB, SEG, CAP>;
  constexpr int smem = F32BwdSmem<DB>::BYTES;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.hq, (p.nk + F32B_BLOCK_N - 1) / F32B_BLOCK_N, batch);
  kernel<<<grid, F32B_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DB>
cudaError_t bwd_f32_dispatch(const BwdF32Params& p, bool seg, bool cap, int batch,
                             cudaStream_t stream) {
  if (seg) {
    return cap ? bwd_f32_launch<DB, true, true>(p, batch, stream)
               : bwd_f32_launch<DB, true, false>(p, batch, stream);
  }
  return cap ? bwd_f32_launch<DB, false, true>(p, batch, stream)
             : bwd_f32_launch<DB, false, false>(p, batch, stream);
}

bool aligned_to(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// dQ, dK, dV of attention on f32 inputs: q / dout [B, Hq, Nq, D] and k / v
// [B, Hkv, Nk, D] f32 (unit stride on D, other strides multiples of 4
// elements, 16-byte aligned), lse / delta [B, Hq, nq_pad] f32 contiguous
// (nq_pad a multiple of 32, rows past Nq never read as live), dq [B, Hq, Nq,
// D] f32 zeroed and added to, dk / dv [B, Hq, Nk, D] f32 per query head (every
// row written); causal, the window (wl, wr; a negative bound is none) and the
// absolute offsets (q_off, kv_off) as in K3's fa_bwd_sm90; segment ids as four
// pointers or none --
//   seg_q [B, q_tiles * 32] and seg_kv [B, kv_tiles * 128] int32 contiguous,
//     16-byte aligned: the ids of the rows below Nq and of the keys below
//     kv_valid_len, each row padded to whole tiles;
//   q_range [B, q_tiles] and kv_range [B, kv_tiles] int32 (min, max) pairs:
//     each 32-row Q tile's and each 128-key tile's id range,
// with q_tiles = ceil(Nq / 32) and kv_tiles = ceil(kv_valid_len / 128); the
// argument list of fa_bwd_split_sm90 (flash_bwd_split_sm90.cu) at these tiles.
// softcap > 0 the forward's cap, 0 none; neither option is K3's call.
// Returns a cudaError_t (0: success; cudaErrorInvalidValue for arguments it
// does not take).
int fa_bwd_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, const void* seg_q,
               const void* seg_kv, const void* q_range, const void* kv_range, int batch, int hq,
               int hkv, int nq, int nk, int d, int kv_valid_len, int causal, int wl, int wr,
               int q_off, int kv_off, int nq_pad, float scale, float softcap, int64_t q_sb,
               int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
               int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh,
               int64_t do_sn, void* stream) {
  const bool seg = seg_q != nullptr;
  const bool cap = softcap > 0.f;
  if (d < 8 || d > 128 || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq > 65535 || hq % hkv != 0 || nq < 1 || nk < 1 ||
      (nk + F32B_BLOCK_N - 1) / F32B_BLOCK_N > 65535 || kv_valid_len < 0 ||
      kv_valid_len > nk || nq_pad < nq || nq_pad % F32B_BLOCK_M || !(softcap >= 0.f) ||
      seg != (seg_kv != nullptr) || seg != (q_range != nullptr) ||
      seg != (kv_range != nullptr) ||
      (seg && (!aligned_to(seg_q, 16) || !aligned_to(seg_kv, 16) || !aligned_to(q_range, 8) ||
               !aligned_to(kv_range, 8))) ||
      !aligned_to(q, 16) || !aligned_to(k, 16) || !aligned_to(v, 16) ||
      !aligned_to(dout, 16) || !aligned_to(lse, 16) || !aligned_to(delta, 16) ||
      !aligned_to(dq, 8) || !aligned_to(dk, 8) || !aligned_to(dv, 8) ||
      (q_sb | q_sh | q_sn) % 4 || (k_sb | k_sh | k_sn) % 4 || (v_sb | v_sh | v_sn) % 4 ||
      (do_sb | do_sh | do_sn) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fa::BwdF32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_range = static_cast<const int2*>(q_range);
  p.kv_range = static_cast<const int2*>(kv_range);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sn = do_sn;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nq_pad = nq_pad;
  p.nk = nk;
  p.kv_valid_len = kv_valid_len;
  p.d = d;
  band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_off) - kv_off);
  p.q_tiles = (nq + F32B_BLOCK_M - 1) / F32B_BLOCK_M;
  p.kv_tiles = (kv_valid_len + F32B_BLOCK_N - 1) / F32B_BLOCK_N;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.cap_scale = cap ? scale / softcap : 0.f;
  p.cap_log2 = softcap * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = d <= 64 ? bwd_f32_dispatch<64>(p, seg, cap, batch, s)
                                : bwd_f32_dispatch<128>(p, seg, cap, batch, s);
  return static_cast<int>(e);
}

}  // extern "C"
