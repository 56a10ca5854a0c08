// K1's f32 route: the C entry fa_fwd_f32 and the eight instantiations (D
// boxes 64 and 128, without and with segment ids, without and with the logit
// softcap) of fwd_f32_tile.cuh's body. The band and the tails are runtime
// ints; segment ids and the softcap change the inner loop and are template
// flags. What it replaces, what bounds it and its design are in
// fwd_f32_tile.cuh; the route (ops/flash_fwd.py::f32_route: every CUDA call on
// an f32 q) is decided in Python.

#include "fwd_f32_tile.cuh"

namespace {

template <int DB, bool SEG, bool CAP>
cudaError_t fwd_f32_launch(const FwdF32Params& p, int batch, cudaStream_t stream) {
  auto kernel = fwd_f32_kernel<DB, SEG, CAP>;
  constexpr int smem = F32FwdSmem<DB>::BYTES;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.hq, p.q_tiles, batch);
  kernel<<<grid, F32_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DB>
cudaError_t fwd_f32_dispatch(const FwdF32Params& p, bool seg, bool cap, int batch,
                             cudaStream_t stream) {
  if (seg) {
    return cap ? fwd_f32_launch<DB, true, true>(p, batch, stream)
               : fwd_f32_launch<DB, true, false>(p, batch, stream);
  }
  return cap ? fwd_f32_launch<DB, false, true>(p, batch, stream)
             : fwd_f32_launch<DB, false, false>(p, batch, stream);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// O and LSE for q [B, Hq, Nq, D] and k/v [B, Hkv, Nk, D] f32 (unit stride on
// D, other strides in elements), o [B, Hq, Nq, D] f32, lse [B, Hq, Nq] f32
// contiguous: the arguments of K1's dense route (fa_fwd_sm90,
// flash_fwd_sm90.cu), in its order and with its meaning -- absolute
// positions q_off + row and kv_off + key for causal and the window (wl, wr;
// a negative bound is none), dead rows (O = 0, LSE = ln2 * mask), segment ids
// as four pointers or none (seg_q [B, Nq] with batch stride seg_q_sb, unit
// along the rows; seg_kv [B, kv_tiles * 64] contiguous, padded to whole tiles
// of 64; q_range [B, q_tiles] and kv_range [B, kv_tiles] (min, max) pairs of
// each 128-row Q tile and 64-key tile), softcap > 0 the cap (0: none).
// Requires 8 <= D <= 128 with D % 8 == 0, Hq % Hkv == 0, 1 <= Nq, 0 <=
// kv_valid_len, B <= 65535; q, k, v 16-byte aligned with strides that are
// multiples of 4 elements; o 8-byte aligned with even strides; seg_kv 16-byte
// aligned. Returns a cudaError_t (0 on success; cudaErrorInvalidValue for
// arguments it does not take).
int fa_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
               const void* seg_q, const void* seg_kv, const void* q_range, const void* kv_range,
               int batch, int hq, int hkv, int nq, int d, int kv_valid_len, int causal, int wl,
               int wr, int q_off, int kv_off, float scale, float softcap, int64_t q_sb,
               int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
               int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh,
               int64_t o_sn, int64_t seg_q_sb, void* stream) {
  const bool seg = seg_q != nullptr;
  const int q_tiles = (nq + F32_BLOCK_M - 1) / F32_BLOCK_M;
  if (d < 8 || d > 128 || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq > 65535 || hq % hkv != 0 || nq < 1 || q_tiles > 65535 || kv_valid_len < 0 ||
      !(softcap >= 0.f) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      reinterpret_cast<uintptr_t>(o) % 8 || (q_sb | q_sh | q_sn) % 4 ||
      (k_sb | k_sh | k_sn) % 4 || (v_sb | v_sh | v_sn) % 4 || (o_sb | o_sh | o_sn) % 2 ||
      seg != (seg_kv != nullptr) || seg != (q_range != nullptr) ||
      seg != (kv_range != nullptr) || (seg && !aligned16(seg_kv))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fa::FwdF32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_range = static_cast<const int2*>(q_range);
  p.kv_range = static_cast<const int2*>(kv_range);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.seg_q_sb = seg_q_sb;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.d = d;
  p.kv_valid_len = kv_valid_len;
  band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_off) - kv_off);
  p.q_tiles = q_tiles;
  p.kv_tiles = (kv_valid_len + F32_BLOCK_N - 1) / F32_BLOCK_N;
  p.scale_log2 = scale * fa::LOG2E;
  const bool cap = softcap > 0.f;
  p.cap_scale = cap ? scale / softcap : 0.f;
  p.cap_log2 = softcap * fa::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = d <= 64 ? fwd_f32_dispatch<64>(p, seg, cap, batch, s)
                                : fwd_f32_dispatch<128>(p, seg, cap, batch, s);
  return static_cast<int>(e);
}

}  // extern "C"
