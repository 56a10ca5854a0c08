// K1 with a sliding window on bf16 K/V without bias (flashattn_tpu/ops/
// flash_fwd.py:54-74's band; with causal, Mistral-style sliding-window
// attention, which the TPU runs on K2's resident and macro routes,
// flash_fwd.py:516 and :852): fwd_tile.cuh's body as fwd_window_kernel, with
// or without segment ids, at head dims above 128 (below, K1's dense route in
// flash_fwd_sm90.cu takes these calls). In a source of its own so that nvcc
// builds it in parallel with the other K1 families. Reached through fa_fwd
// (flash_fwd.cu).

#include "fwd_tile.cuh"

cudaError_t fa::fwd_window_bf16(const FwdParams& p, int batch, cudaStream_t stream) {
  return p.seg_q != nullptr ? fwd_launch_wide<true, false, false, true>(p, batch, stream)
                            : fwd_launch_wide<false, false, false, true>(p, batch, stream);
}
