// K1 over int8 K/V with per-token f32 scales, dequantized in the kernel
// (flashattn_tpu/ops/flash_fwd.py:259-260, 304-309, 342-345, reached through
// flashattn_tpu/ops/quant.py::flash_attention_quantized), with or without an
// additive bias: the instantiations of fwd_tile.cuh's kernel for the int8 KV
// cache. Reached through fa_fwd (flash_fwd.cu).

#include "fwd_tile.cuh"

cudaError_t fa::fwd_int8(const FwdParams& p, int batch, cudaStream_t stream) {
  return p.bias != nullptr ? fwd_launch<true, KV_INT8>(p, batch, stream)
                           : fwd_launch<false, KV_INT8>(p, batch, stream);
}
