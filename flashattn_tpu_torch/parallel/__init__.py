"""Sequence parallelism: ring attention on the ring kernels K7 and K8."""

from flashattn_tpu_torch.parallel.ring_kernel import (
    ring_attention_kernel,
    ring_attention_kernel_sharded,
)

__all__ = ["ring_attention_kernel", "ring_attention_kernel_sharded"]
