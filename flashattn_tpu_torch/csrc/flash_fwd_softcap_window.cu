// K1 with logit soft-capping and a sliding window on bf16 K/V without bias
// (Gemma-2-style local attention; flashattn_tpu/ops/flash_fwd.py:310-318 and
// :54-74) at head dims above 128 (below, K1's dense route in
// flash_fwd_sm90.cu takes these calls): fwd_tile.cuh's body as
// fwd_window_kernel with CAP, with or without segment ids. In a source of
// its own so that nvcc builds it in parallel with the other K1 families.
// Reached through fa_fwd (flash_fwd.cu).

#include "fwd_tile.cuh"

cudaError_t fa::fwd_softcap_window_bf16(const FwdParams& p, int batch, cudaStream_t stream) {
  return p.seg_q != nullptr ? fwd_launch_wide<true, false, true, true>(p, batch, stream)
                            : fwd_launch_wide<false, false, true, true>(p, batch, stream);
}
