// K1 with logit soft-capping on bf16 K/V (flashattn_tpu/ops/flash_fwd.py:310-318,
// Gemma-2's attn_logit_softcapping) at head dims above 128 (below, K1's
// Hopper routes in flash_fwd_sm90.cu and flash_fwd_bias_sm90.cu take these
// calls): the instantiations of fwd_tile.cuh's body as fwd_softcap_kernel,
// with segment ids, with an additive bias or with neither, each with or
// without causal; the window's instantiations are in
// flash_fwd_softcap_window.cu. In a source of its own so that nvcc builds it
// in parallel with the other K1 families. Reached through fa_fwd
// (flash_fwd.cu).

#include "fwd_tile.cuh"

cudaError_t fa::fwd_softcap_bf16(const FwdParams& p, int batch, cudaStream_t stream) {
  if (p.seg_q != nullptr) return fwd_launch_wide<true, false, true, false>(p, batch, stream);
  return p.bias != nullptr ? fwd_launch_wide<false, true, true, false>(p, batch, stream)
                           : fwd_launch_wide<false, false, true, false>(p, batch, stream);
}
