"""The port's ring attention gradients (K8's plain version over the backward
ring) against jax.grad of the JAX ring kernel on the virtual CPU mesh.

The JAX side differentiates ``ring_attention_kernel`` inside ``shard_map``
(tests/test_ring_kernel.py:83-108): its custom_vjp runs the in-kernel ring
backward, Pallas in interpret mode. The port differentiates
``ring_attention_kernel_sharded`` with autograd on CPU tensors. Inputs and
the output cotangent are drawn in f32 with numpy from a seed and handed to
both; the budget is BWD_TOL[f32], the package's f32 gradient budget.
"""

import numpy as np
import pytest
import torch

from flashattn_tpu_torch.parallel import ring_attention_kernel_sharded
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

H, NQ = 2, 128


# (ranks, causal, window, Hkv, D): both masks, both windows and GQA with one
# KV head at 4 ranks (the JAX race-detected backward's cases), and 2 ranks;
# head dims above 128 (D 256, D 136 with a window and GQA) and one the entry
# point pads (D 100).
GRAD_CASES = [
    (2, True, None, 2, 128),
    (2, False, None, 1, 64),
    (4, True, None, 2, 64),
    (4, True, (160, -1), 2, 64),
    (4, False, (160, 160), 2, 64),
    (4, True, None, 1, 64),
    (2, True, None, 1, 256),
    (4, True, (160, -1), 1, 136),
    (2, False, None, 2, 100),
]


@pytest.mark.parametrize("ranks,causal,window,hkv,d", GRAD_CASES)
def test_ring_grads_match_jax_ring_kernel(ranks, causal, window, hkv, d):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec

    from flashattn_tpu.parallel.ring_kernel import ring_attention_kernel
    from flashattn_tpu.utils import platform

    if jax.device_count() < ranks:
        pytest.skip(f"needs {ranks} devices (virtual CPU mesh)")
    platform.patch_io_callback_inline()
    mesh = Mesh(np.array(jax.devices()[:ranks]), axis_names=("seq",))
    q, k, v = make_qkv(ranks * 7 + d + hkv, 1, H, ranks * NQ, d, Hkv=hkv)
    do = make_qkv(ranks * 7 + d + 1, 1, H, ranks * NQ, d)[0]

    def loss(a, b, c, g):
        o = ring_attention_kernel(a, b, c, axis_name="seq", axis_size=ranks, causal=causal,
                                  window=window)
        return jnp.sum(o * g)

    spec = PartitionSpec(None, None, "seq", None)
    want = jax.jit(jax.shard_map(
        jax.grad(loss, argnums=(0, 1, 2)), mesh=mesh, in_specs=(spec,) * 4,
        out_specs=(spec,) * 3, check_vma=False,
    ))(*(jnp.asarray(x.numpy()) for x in (q, k, v, do)))

    leaves = tuple(x.clone().requires_grad_(True) for x in (q, k, v))
    o = ring_attention_kernel_sharded(ranks=ranks, causal=causal, window=window)(*leaves)
    got = torch.autograd.grad(o, leaves, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, np.asarray(w), BWD_TOL[torch.float32], name)


def test_fp16_runs_as_bf16_and_comes_back_in_fp16():
    """The dtype dispatch of the entry points: fp16 is cast to bf16 (the
    kernels' type) and the output and gradients return in fp16, within the
    bf16 budgets of the f32 ring."""
    q, k, v = make_qkv(61, 1, 2, 2 * NQ, 64)
    do = make_qkv(62, 1, 2, 2 * NQ, 64)[0]
    ring = ring_attention_kernel_sharded(ranks=2, causal=True)
    grads = []
    for dt in (torch.float16, torch.float32):
        leaves = tuple(x.to(dt).requires_grad_(True) for x in (q, k, v))
        o = ring(*leaves)
        grads.append((o, *torch.autograd.grad(o, leaves, do.to(dt))))
    assert all(x.dtype == torch.float16 for x in grads[0])
    assert_close(grads[0][0], grads[1][0], FWD_TOL[torch.float16], "O")
    for name, g, w in zip(("dq", "dk", "dv"), grads[0][1:], grads[1][1:]):
        assert_close(g, w, BWD_TOL[torch.float16], name)
