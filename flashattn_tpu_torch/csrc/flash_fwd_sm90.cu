// K1's dense route for Hopper (sm_90a): the C entry fa_fwd_sm90 and the
// twelve instantiations (D 64, 128 and 256, without and with segment ids,
// without and with the logit softcap) of fwd_sm90_tile.cuh's body without
// the bias stream, as fwd_dense_sm90_kernel<D, SEG, CAP>. D 256 takes every
// head dim from 136 (its TMA boxes read zeros past D). The causal / window band and
// the tails are runtime ints, as in K7 (ring_fwd.cu), and segment ids and
// the softcap the compile-time options: a runtime segment flag cost
// the mma.sync K1 without segments 50% (PERF.md §6), and the cap puts a tanhf
// on every score. What it replaces, what bounds it and its design are in
// fwd_sm90_tile.cuh; the route (ops/flash_fwd.py::dense_route) is decided in
// Python, and the calls it refuses (a bias, int8 / fp8 K/V) go to other
// kernels. The library's fa_error_string is here too.

#include "fwd_sm90_tile.cuh"

namespace {

template <int D, bool SEG, bool CAP>
__global__ void __launch_bounds__(FB_THREADS, 1)
    fwd_dense_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const FwdDenseParams p) {
  fwd_sm90_body<D, false, SEG, CAP>(tm_q, tm_k, tm_v, p);
}

template <int D, bool CAP>
cudaError_t fwd_dense_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                             const CUtensorMap& tm_v, const FwdDenseParams& p, int batch,
                             cudaStream_t stream) {
  constexpr int smem = FbSmem<D, false>::BYTES;
  return p.seg_q != nullptr
             ? fwd_sm90_launch(fwd_dense_sm90_kernel<D, true, CAP>, smem, tm_q, tm_k, tm_v, p,
                               batch, stream)
             : fwd_sm90_launch(fwd_dense_sm90_kernel<D, false, CAP>, smem, tm_q, tm_k, tm_v, p,
                               batch, stream);
}

template <int D>
cudaError_t fwd_dense_dispatch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                               const CUtensorMap& tm_v, const FwdDenseParams& p, bool cap,
                               int batch, cudaStream_t stream) {
  return cap ? fwd_dense_launch<D, true>(tm_q, tm_k, tm_v, p, batch, stream)
             : fwd_dense_launch<D, false>(tm_q, tm_k, tm_v, p, batch, stream);
}

}  // namespace

extern "C" {

// O and LSE for q [B, Hq, Nq, D] and k/v [B, Hkv, Nk, D] bf16 (unit stride on
// D, other strides in elements); o has q's shape, lse is [B, Hq, Nq] f32
// contiguous. Positions are absolute, q_pos = q_off + row and kv_pos = kv_off
// + key (a chunk pair of a sequence-parallel caller): causal != 0 masks
// kv_pos > q_pos; the window (wl, wr) masks kv_pos < q_pos - wl (wl >= 0) and
// kv_pos > q_pos + wr (wr >= 0), a negative bound being none. A row that
// sees no key (a band that misses it, or a Q tile that meets no KV tile) is
// dead: O = 0 and LSE = ln2 * mask. Segment ids: all four pointers or
// none --
//   seg_q [B, Nq] int32, unit stride along the rows, batch stride seg_q_sb;
//   seg_kv [B, kv_tiles * T] int32 contiguous: the ids of the keys below
//     kv_valid_len, each row padded to whole KV tiles of T keys (the padding
//     is never compared);
//   q_range [B, q_tiles] and kv_range [B, kv_tiles] int32 pairs (min, max),
//     contiguous: the id range of each 128-row Q tile's rows below Nq and of
//     each T-key tile's keys below kv_valid_len,
// with q_tiles = ceil(Nq / 128), kv_tiles = ceil(kv_valid_len / T) and T
// the KV tile (dense_kv_tile: 64 up to D 128, 80 above).
// softcap > 0 caps the scaled scores at softcap * tanh(s / softcap), 0 none.
// Requires 8 <= D <= 256 with D % 8 == 0, Hq % Hkv == 0, 1 <= Nq,
// 0 <= kv_valid_len <= Nk, B <= 65535; q, k, v 16-byte aligned with strides
// that are multiples of 8 elements and nonzero on dims of extent > 1 (TMA's);
// o 4-byte aligned with even strides; seg_kv 16-byte aligned. Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for arguments it does not
// take, cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or
// refuses a tensor map).
int fa_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                const void* seg_q, const void* seg_kv, const void* q_range, const void* kv_range,
                int batch, int hq, int hkv, int nq, int d, int kv_valid_len, int causal, int wl,
                int wr, int q_off, int kv_off, float scale, float softcap, int64_t q_sb,
                int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh,
                int64_t o_sn, int64_t seg_q_sb, void* stream) {
  // The K/V maps' sequence extent (at least 1: a map has no empty dim; with
  // kv_valid_len 0 no KV tile is loaded).
  const int nkv = kv_valid_len > 0 ? kv_valid_len : 1;
  const bool seg = seg_q != nullptr;
  if (d < 8 || d > 256 || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq % hkv != 0 || nq < 1 || (nq + FB_BLOCK_M - 1) / FB_BLOCK_M > 65535 ||
      kv_valid_len < 0 || !(softcap >= 0.f) || !aligned(q, 16) || !aligned(k, 16) ||
      !aligned(v, 16) ||
      !aligned(o, 4) || !tma_strides(q_sb, batch, q_sh, hq, q_sn, nq) ||
      !tma_strides(k_sb, batch, k_sh, hkv, k_sn, nkv) ||
      !tma_strides(v_sb, batch, v_sh, hkv, v_sn, nkv) || o_sb % 2 || o_sh % 2 || o_sn % 2 ||
      seg != (seg_kv != nullptr) || seg != (q_range != nullptr) ||
      seg != (kv_range != nullptr) || (seg && !aligned(seg_kv, 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  const int kv_tile = dense_kv_tile(d);  // keys per KV tile: 80 in the D 256 form
  if (!make_bhnd_map(&tm_q, q, batch, hq, nq, d, q_sb, q_sh, q_sn, FB_BLOCK_M) ||
      !make_bhnd_map(&tm_k, k, batch, hkv, nkv, d, k_sb, k_sh, k_sn, kv_tile) ||
      !make_bhnd_map(&tm_v, v, batch, hkv, nkv, d, v_sb, v_sh, v_sn, kv_tile)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  fa::FwdDenseParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_range = static_cast<const int2*>(q_range);
  p.kv_range = static_cast<const int2*>(kv_range);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.seg_q_sb = seg_q_sb;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.d = d;
  p.kv_valid_len = kv_valid_len;
  band_bounds(causal, wl, wr, &p.lo, &p.hi,
              static_cast<int64_t>(q_off) - kv_off);  // K1 dense offsets
  p.q_tiles = (nq + FB_BLOCK_M - 1) / FB_BLOCK_M;
  p.kv_tiles = (kv_valid_len + kv_tile - 1) / kv_tile;
  p.scale_log2 = scale * fa::LOG2E;
  const bool cap = softcap > 0.f;
  p.cap_scale = cap ? scale / softcap : 0.f;
  p.cap_log2 = softcap * fa::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      d <= 64    ? fwd_dense_dispatch<64>(tm_q, tm_k, tm_v, p, cap, batch, s)
      : d <= 128 ? fwd_dense_dispatch<128>(tm_q, tm_k, tm_v, p, cap, batch, s)
                 : fwd_dense_dispatch<256>(tm_q, tm_k, tm_v, p, cap, batch, s);
  return static_cast<int>(e);
}

// The message of a cudaError_t that a C entry of this library returned.
const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
