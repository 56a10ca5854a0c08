// K1's decode route for Hopper (sm_90a) on int8 / e4m3 K/V with per-token f32
// scales, with or without a bias: the split-KV decode kernel of
// decode_tile.cuh (what it replaces, what bounds it -- bytes, 0.041 ms at the
// LM's decode shape -- and its design are there), instantiated in a source of
// its own so that its nvcc runs beside flash_decode.cu's. The C entry and the
// merge kernel are in flash_decode.cu.

#include "decode_tile.cuh"

cudaError_t fa::decode_quant(const DecodeParams& p, int batch, int kv_dtype,
                             cudaStream_t stream) {
  const bool bias = p.bias != nullptr;
  if (kv_dtype == KV_INT8) {
    return bias ? decode_launch<KV_INT8, true, false>(p, batch, stream)
                : decode_launch<KV_INT8, false, false>(p, batch, stream);
  }
  return bias ? decode_launch<KV_FP8, true, false>(p, batch, stream)
              : decode_launch<KV_FP8, false, false>(p, batch, stream);
}
