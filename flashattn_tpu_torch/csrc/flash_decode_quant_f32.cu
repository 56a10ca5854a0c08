// K1's decode route for Hopper (sm_90a) on an f32 q over int8 / e4m3 K/V
// with per-token f32 scales, with or without a bias: the F32Q form of
// decode_tile.cuh's split-KV decode kernel (its notes there: q and P as
// three bf16 pieces, K / V widened exactly to one; bytes bound it, 0.0207
// ms at the f32 LM's decode on an int8 cache of 8192), instantiated in a
// source of its own so that its nvcc runs beside flash_decode.cu's. The C
// entry (fa_decode_f32) and the merge kernel are in flash_decode.cu.
//
// Replaces flashattn_tpu/ops/flash_fwd.py::_fwd_kernel (K1, :115) on the
// calls that the f32 LM's decode_step makes on an 8-bit cache: mm_dtype f32
// at Precision.HIGHEST (:232-238), k_scale on the score columns (:304-309),
// v_scale on P before P V (:341-350).

#include "decode_tile.cuh"

cudaError_t fa::decode_quant_f32(const DecodeParams& p, int batch, int kv_dtype,
                                 cudaStream_t stream) {
  const bool bias = p.bias != nullptr;
  if (kv_dtype == KV_INT8) {
    return bias ? decode_launch<KV_INT8, true, false, true>(p, batch, stream)
                : decode_launch<KV_INT8, false, false, true>(p, batch, stream);
  }
  return bias ? decode_launch<KV_FP8, true, false, true>(p, batch, stream)
              : decode_launch<KV_FP8, false, false, true>(p, batch, stream);
}
