"""Distribution layer: meshes, head-parallel, ring attention (on K1 / K3 with
offsets, and on the ring kernels K7 / K8), zigzag and Ulysses (port of
flashattn_tpu/parallel/)."""

from flashattn_tpu_torch.parallel.head_parallel import head_parallel_attention
from flashattn_tpu_torch.parallel.mesh import (
    ProcessGroupMesh,
    VirtualMesh,
    make_mesh,
)
from flashattn_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded
from flashattn_tpu_torch.parallel.ring_kernel import (
    ring_attention_kernel,
    ring_attention_kernel_sharded,
)
from flashattn_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_attention_sharded
from flashattn_tpu_torch.parallel.zigzag import (
    zigzag_ring_attention,
    zigzag_ring_attention_sharded,
    zigzag_shard,
    zigzag_unshard,
)

__all__ = [
    "make_mesh",
    "VirtualMesh",
    "ProcessGroupMesh",
    "head_parallel_attention",
    "ring_attention",
    "ring_attention_sharded",
    "ring_attention_kernel",
    "ring_attention_kernel_sharded",
    "ulysses_attention",
    "ulysses_attention_sharded",
    "zigzag_ring_attention",
    "zigzag_ring_attention_sharded",
    "zigzag_shard",
    "zigzag_unshard",
]
