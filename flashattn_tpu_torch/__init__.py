"""flashattn_tpu_torch — the PyTorch + CUDA port of flashattn_tpu for NVIDIA Hopper.

The JAX package ``flashattn_tpu`` is the reference this package is tested
against; this one imports ``torch`` and never ``jax``. Its kernels are written
by hand for ``sm_90a`` under ``csrc/`` and built with nvcc at first use.
CPU tensors run each kernel's plain PyTorch version.

Public API::

    from flashattn_tpu_torch import flash_attention, scaled_dot_product_attention

    o = flash_attention(q, k, v)                              # [B,H,N,D]
    o = flash_attention(q, k, v, layout="BNHD")               # [B,N,H,D]
    o = scaled_dot_product_attention(q, k, v, layout="BNHD")  # SDPA-style adapter

The distribution layer (``parallel/``: ``make_mesh``, head-parallel, ring,
zigzag and Ulysses attention) is exported here too, as
``flashattn_tpu.parallel`` exports it.
"""

from flashattn_tpu_torch.ops.flash import BlockSizes, flash_attention, flash_attention_with_lse
from flashattn_tpu_torch.ops.oracle import attention_reference
from flashattn_tpu_torch.ops.sdpa import scaled_dot_product_attention
from flashattn_tpu_torch.parallel import (
    head_parallel_attention,
    make_mesh,
    ring_attention,
    ring_attention_kernel,
    ring_attention_kernel_sharded,
    ring_attention_sharded,
    ulysses_attention,
    zigzag_ring_attention,
    zigzag_ring_attention_sharded,
    zigzag_shard,
    zigzag_unshard,
)

__version__ = "0.1.0"

__all__ = [
    "BlockSizes",
    "flash_attention",
    "flash_attention_with_lse",
    "scaled_dot_product_attention",
    "attention_reference",
    "make_mesh",
    "head_parallel_attention",
    "ring_attention",
    "ring_attention_sharded",
    "ring_attention_kernel",
    "ring_attention_kernel_sharded",
    "ulysses_attention",
    "zigzag_ring_attention",
    "zigzag_ring_attention_sharded",
    "zigzag_shard",
    "zigzag_unshard",
    "__version__",
]
