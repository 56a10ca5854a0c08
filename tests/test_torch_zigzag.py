"""The port's zigzag ring attention (``parallel/zigzag.py``) against
``flashattn_tpu.parallel.zigzag`` on the 8-device virtual CPU mesh.

The order and its inverse against the JAX functions; the sharded attention's
output and gradients (autograd against ``jax.grad`` of the JAX function under
``shard_map``, Pallas in interpret mode), with MHA and GQA K/V rotating at
Hkv heads; the live sub-pairs of each rank (2P + 1 over the P steps, the
balance the layout is for); and the odd-length ValueError (the LM step in
the zigzag layout is held in tests/test_torch_sharded_layouts.py). Inputs
are drawn in f32 with numpy from a seed; budgets FWD_TOL / BWD_TOL[f32].
"""

import numpy as np
import pytest
import torch

from flashattn_tpu_torch.parallel import make_mesh, ring, zigzag
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv


def _jax_seq_mesh(n):
    import jax
    from jax.sharding import Mesh

    if jax.device_count() < n:
        pytest.skip(f"needs {n} devices (virtual CPU mesh)")
    return Mesh(np.array(jax.devices()[:n]), axis_names=("seq",))


@pytest.mark.parametrize("n_total,n_dev", [(64, 4), (48, 3), (16, 1)])
def test_order_round_trip_matches_jax(n_total, n_dev):
    from flashattn_tpu.parallel import zigzag as jz

    np.testing.assert_array_equal(zigzag.zigzag_order(n_total, n_dev),
                                  jz.zigzag_order(n_total, n_dev))
    x = torch.arange(2 * n_total * 3.0).reshape(1, 2, n_total, 3)
    z = zigzag.zigzag_shard(x, n_dev)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz.zigzag_shard(x.numpy(), n_dev)))
    assert torch.equal(zigzag.zigzag_unshard(z, n_dev), x)
    with pytest.raises(ValueError, match="divisible"):
        zigzag.zigzag_order(100, 4)


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (4, 1)], ids=["MHA", "GQA 4/2", "GQA 4/1"])
def test_zigzag_matches_jax(hq, hkv):
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.parallel.zigzag import zigzag_ring_attention_sharded as jax_zz

    n = 4
    q, k, v = make_qkv(60 + hq + hkv, 1, hq, n * 64, 32, Hkv=hkv)
    g = make_qkv(61 + hq, 1, hq, n * 64, 32)[0]
    fn = zigzag.zigzag_ring_attention_sharded(make_mesh(seq=n, devices="cpu"), batch_axis=None,
                                              head_axis=None)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fn(*leaves)
    grads = torch.autograd.grad(o, leaves, g)
    jfn = jax_zz(_jax_seq_mesh(n), batch_axis=None, head_axis=None)
    jargs = [jnp.asarray(x.numpy()) for x in (q, k, v)]
    jg = jnp.asarray(g.numpy())
    want = jax.grad(lambda a, b, c: jnp.sum(jfn(a, b, c) * jg), argnums=(0, 1, 2))(*jargs)
    assert_close(o.detach(), np.asarray(jfn(*jargs)), FWD_TOL[torch.float32], "O")
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert_close(a, np.asarray(b), BWD_TOL[torch.float32], name)


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_runs_2p_plus_1_sub_pairs(monkeypatch, n):
    """Over the P steps every rank computes 2P + 1 partials (q_hi x k_lo at
    each step, q_lo x k_lo when src <= d, q_hi x k_hi when src >= d) and as
    many chunk-pair gradients; the contiguous ring's rank r computes r + 1."""
    seen = {"fwd": [], "bwd": []}

    def spy(kind, fn):
        def call(q, *args, **kw):
            seen[kind].append(q.data_ptr())
            return fn(q, *args, **kw)
        return call

    monkeypatch.setattr(ring, "_partial_fwd", spy("fwd", ring._partial_fwd))
    monkeypatch.setattr(ring, "_chunk_grads", spy("bwd", ring._chunk_grads))
    mesh = make_mesh(seq=n, devices="cpu")
    q, k, v = (x.requires_grad_(True) for x in make_qkv(62, 1, 2, n * 32, 16))
    zigzag.zigzag_ring_attention_sharded(mesh, batch_axis=None, head_axis=None)(
        q, k, v).sum().backward()
    assert len(seen["fwd"]) == len(seen["bwd"]) == n * (2 * n + 1)
    seen = {"fwd": [], "bwd": []}
    ring.ring_attention_sharded(mesh, batch_axis=None, head_axis=None, causal=True)(
        q, k, v).sum().backward()
    assert len(seen["fwd"]) == len(seen["bwd"]) == n * (n + 1) // 2


def test_odd_local_length_rejected():
    mesh = make_mesh(seq=2, devices="cpu")
    q = torch.zeros(1, 2, 7, 16)
    with pytest.raises(ValueError, match="must be even"):
        zigzag.zigzag_ring_attention([q, q], [q, q], [q, q], mesh=mesh)
