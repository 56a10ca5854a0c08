// The f32 routes' operand split (split_bf16x3.cu): its launcher, which K1's
// f32 route (flash_fwd_f32.cu) and the f32 backward (flash_bwd_f32.cu) call
// from their C entries before their attention kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

// One f32 [B, H, N, D] operand (strides in elements, unit on D) and where its
// three bf16 pieces go: [3, B, H, N, db] contiguous, zeros past D.
struct SplitArg {
  const void* x;
  void* out;
  int batch, heads, n, d;
  int64_t sb, sh, sn;
};

constexpr int SPLIT_MAX_TENSORS = 4;

// Launch the split of count <= SPLIT_MAX_TENSORS operands, one launch for all
// (1 <= D <= db, db a multiple of 8, out 16-byte aligned); returns
// cudaErrorInvalidValue for arguments it does not take, else the launch's
// error.
cudaError_t split_bf16x3(const SplitArg* args, int count, int db, cudaStream_t stream);

}  // namespace fa
