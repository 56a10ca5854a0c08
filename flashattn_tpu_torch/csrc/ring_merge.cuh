// The epilogue of every form of K7, the ring forward step (ring_fwd.cu's
// bf16 body at D <= 128, K1's dense body at D 136-256 launched as a ring step
// from ring_fwd.cu, and K1's f32 bodies launched as ring steps from
// flash_fwd_f32.cu): the chunk's partial, as the online softmax leaves it in
// a consumer thread's registers, merged into the rank's running f32 state by
// the LSE rule of flashattn_tpu/parallel/ring_kernel.py:342-347, or, on the
// rank's last live step, finalized into O and the LSE (:373-378).

#pragma once

#include "common.cuh"

namespace fa {

// One rank's running state of the ring forward and the step's place in the
// ring: the first live step starts from (m, l, acc) = (mask, 0, 0) without
// reading the state (which may be null with last), the last writes O and the
// LSE instead of the state.
struct RingState {
  float* acc;  // [B, Hq, nq, d] f32 contiguous: running unnormalized O
  float* m;    // [B, Hq, nq] f32 contiguous: running max (log2 units)
  float* l;    // [B, Hq, nq] f32 contiguous: running sum
  int first, last;
};

// Prefetch into L2 the state that ring_merge_store reads for the `rows` rows
// from row0 (acc's rows are contiguous, as are m's and l's): three bulk
// prefetches, none on the first step, which reads no state.
__device__ __forceinline__ void ring_prefetch_state(const RingState& st, int hq, int nq, int d,
                                                    int b, int h, int row0, int rows) {
  if (st.first) return;
  const int64_t srow = (static_cast<int64_t>(b) * hq + h) * nq + row0;
  const void* src[3] = {st.acc + srow * d, st.m + srow, st.l + srow};
  const uint32_t bytes[3] = {static_cast<uint32_t>(rows * d * 4), static_cast<uint32_t>(rows * 4),
                             static_cast<uint32_t>(rows * 4)};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src[i]), "r"(bytes[i])
                 : "memory");
  }
}

// The state's column pairs a thread reads ahead in ring_merge_store (a
// divisor of D / 8 at D 64, 128 and 256). One at a time, each read waiting
// on the store before it, the merge took 13% of K7's D 256 off-diagonal step
// with the state prefetched into L2 (chip_variants.py k1wide).
constexpr int RING_MERGE_AHEAD = 8;

// Merge this thread's partial into the state: its rows row0 and row0 + 8
// (local rows of the chunk) in the wgmma accumulator layout, o[4jj + 2r + e]
// being row row0 + 8r, column 8jj + 2t + e; m_i in log2 units (quad-uniform)
// and l_i this thread's partial row sums (reduced over the quad here). A
// partial whose max is at or below half the mask value (a row the band left
// no column of this chunk) is dropped, as is a state row in that condition.
// On the last step O = acc / l in OT (bf16 or f32) through its (batch, head,
// seq) strides, and LSE = (m + log2 l) ln2 into lse [B, Hq, nq]; a row no step
// gave a column gets O = 0 and LSE = -inf (every row is below nq: the C entries
// take chunks of whole 128-row tiles). The state is read and written in
// float2 column pairs straight from global memory, RING_MERGE_AHEAD pairs
// at a time, so a D 256 accumulator (128 registers a thread) needs no
// second copy. Columns >= d are neither
// read nor written.
template <int D, typename OT>
__device__ __forceinline__ void ring_merge_store(const RingState& st, OT* o, int64_t o_sb,
                                                 int64_t o_sh, int64_t o_sn, float* lse, int hq,
                                                 int nq, int d, const float (&acc)[D / 2],
                                                 const float (&m_i)[2], const float (&l_i)[2],
                                                 int b, int h, int row0, int t) {
  static_assert((D / 8) % RING_MERGE_AHEAD == 0, "whole groups of column pairs");
  constexpr float NEG = 0.5f * MASK_VALUE;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    const int64_t srow = (static_cast<int64_t>(b) * hq + h) * nq + row;
    const float m_run = st.first ? MASK_VALUE : st.m[srow];
    const float l_run = st.first ? 0.f : st.l[srow];
    const float m_new = fmaxf(m_run, m_i[r]);
    const float a_run = m_run <= NEG ? 0.f : exp2f(m_run - m_new);
    const float a_c = m_i[r] <= NEG ? 0.f : exp2f(m_i[r] - m_new);
    const float l_new = l_run * a_run + l * a_c;
    const bool alive = l_new > 0.f;
    float* acc_row = st.acc + srow * d;
    const float inv = st.last && alive ? 1.f / l_new : 0.f;
    OT* o_row = o + b * o_sb + h * o_sh + static_cast<int64_t>(row) * o_sn;
    // RING_MERGE_AHEAD column pairs of the state are read before any of
    // them is written back, so that their loads are in flight together.
#pragma unroll
    for (int j0 = 0; j0 < D / 8; j0 += RING_MERGE_AHEAD) {  // K7 merge columns
      float2 prev[RING_MERGE_AHEAD];
#pragma unroll
      for (int u = 0; u < RING_MERGE_AHEAD; ++u) {
        const int col = 8 * (j0 + u) + 2 * t;
        prev[u] = st.first || col >= d ? make_float2(0.f, 0.f)
                                       : *reinterpret_cast<const float2*>(acc_row + col);
      }
#pragma unroll
      for (int u = 0; u < RING_MERGE_AHEAD; ++u) {
        const int jj = j0 + u;
        const int col = 8 * jj + 2 * t;
        if (col >= d) continue;
        const float x = prev[u].x * a_run + acc[4 * jj + 2 * r] * a_c;
        const float y = prev[u].y * a_run + acc[4 * jj + 2 * r + 1] * a_c;
        if (!st.last) {
          *reinterpret_cast<float2*>(acc_row + col) = make_float2(x, y);
        } else if constexpr (sizeof(OT) == 4) {
          *reinterpret_cast<float2*>(o_row + col) = make_float2(x * inv, y * inv);
        } else {
          *reinterpret_cast<uint32_t*>(o_row + col) = pack_bf16(x * inv, y * inv);
        }
      }
    }
    if (t == 0) {
      if (st.last) {
        lse[srow] = alive ? (m_new + log2f(l_new)) * LN2 : -INFINITY;
      } else {
        st.m[srow] = m_new;
        st.l[srow] = l_new;
      }
    }
  }
}

}  // namespace fa
