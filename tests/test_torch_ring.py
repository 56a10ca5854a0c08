"""The port's ring attention (``parallel/ring.py``) against the JAX
package's on the 8-device virtual CPU mesh.

``ring_attention(_sharded)`` of the port runs on a ``VirtualMesh`` of CPU
ranks, each chunk pair on the plain versions of K1 / K3 / the split route
with the pair's q / kv offsets; the JAX function runs under ``shard_map`` on
the virtual devices of ``tests/conftest.py`` (Pallas in interpret mode).
Inputs and the output cotangent are drawn in f32 with numpy from a seed and
handed to both; outputs within FWD_TOL[f32] and gradients (autograd against
``jax.grad`` of the same global function) within BWD_TOL[f32].
"""

import numpy as np
import pytest
import torch

from flashattn_tpu_torch.parallel import make_mesh, ring_attention, ring_attention_sharded
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

F32_FWD, F32_BWD = FWD_TOL[torch.float32], BWD_TOL[torch.float32]


def _jax_mesh(data=1, model=1, seq=1):
    import jax

    from flashattn_tpu.parallel import make_mesh as jax_make_mesh

    if jax.device_count() < data * model * seq:
        pytest.skip(f"needs {data * model * seq} devices (virtual CPU mesh)")
    return jax_make_mesh(data=data, model=model, seq=seq)


def _inputs(seed, B, Hq, N, D, Hkv=None):
    q, k, v = make_qkv(seed, B, Hq, N, D, Hkv=Hkv)
    return q, k, v, make_qkv(seed + 1, B, Hq, N, D)[0]


def _packed(seed, B, N, docs=3):
    """Sorted packed ids [B, N]: ``docs`` runs of random lengths."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, N), docs - 1, replace=False))
    row = np.zeros(N, np.int32)
    for c in cuts:
        row[c:] += 1
    return torch.from_numpy(np.tile(row, (B, 1)))


def _both(port_fn, jax_fn, tensors, extra=()):
    """Output and gradients of ``port_fn`` (autograd) and ``jax_fn``
    (jax.grad of <O, g>) on the same f32 inputs; ``tensors`` = (q, k, v, g),
    ``extra`` the segment ids, if any."""
    import jax
    import jax.numpy as jnp

    q, k, v, g = tensors
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = port_fn(*leaves, *extra)
    got = (o.detach(), *torch.autograd.grad(o, leaves, g))
    jargs = [jnp.asarray(x.numpy()) for x in (q, k, v)]
    jextra = [jnp.asarray(np.asarray(e)) for e in extra]
    jg = jnp.asarray(g.numpy())
    jo = jax_fn(*jargs, *jextra)
    grads = jax.grad(lambda a, b, c: jnp.sum(jax_fn(a, b, c, *jextra) * jg),
                     argnums=(0, 1, 2))(*jargs)
    want = (np.asarray(jo), *(np.asarray(x) for x in grads))
    assert_close(got[0], want[0], F32_FWD, "O")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert_close(a, b, F32_BWD, name)


# ---------------------------------------------------------------------------
# ring attention


# (mesh (data, model, seq), Hq, Hkv, options): causal and not, a causal
# window whose left edge cuts the chunks, segment ids, GQA with K/V rotating
# at Hkv, and heads x sequence x batch.
RING_CASES = {
    "causal": ((1, 1, 4), 2, 2, dict(causal=True)),
    "non-causal": ((1, 1, 4), 2, 2, {}),
    "window": ((1, 1, 4), 2, 2, dict(causal=True, window=(100, -1))),
    "segment ids": ((1, 1, 4), 2, 2, dict(causal=True, ids=True)),
    "GQA at Hkv": ((1, 1, 4), 4, 1, dict(causal=True)),
    "heads x seq x data": ((2, 2, 2), 4, 2, dict(causal=True)),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_matches_jax(case):
    from flashattn_tpu.parallel import ring_attention_sharded as jax_ring

    (data, model, seq), hq, hkv, opts = RING_CASES[case]
    kw = dict(opts)
    ids = kw.pop("ids", False)
    tensors = _inputs(20 + hq + hkv, 2, hq, 256, 32, Hkv=hkv)
    extra = (_packed(21, 2, 256),) if ids else ()
    axes = dict(batch_axis="data" if data > 1 else None,
                head_axis="model" if model > 1 else None)
    _both(ring_attention_sharded(make_mesh(data, model, seq, devices="cpu"),
                                 with_segment_ids=ids, **axes, **kw),
          jax_ring(_jax_mesh(data, model, seq), with_segment_ids=ids, **axes, **kw),
          tensors, extra)


def test_ring_tuple_ids_rotate_with_kv():
    """ring_attention on local chunks with (q_ids, kv_ids) pairs: the kv ids
    rotate with K/V, and the result is the single-array call's."""
    mesh = make_mesh(seq=4, devices="cpu")
    q, k, v, _ = _inputs(30, 1, 2, 256, 32)
    ids = _packed(31, 1, 256)
    spec = (None, None, "seq", None)
    shards = [mesh.shard(x, spec) for x in (q, k, v)]
    id_shards = mesh.shard(ids, (None, "seq"))
    one = ring_attention(*shards, mesh=mesh, causal=True, segment_ids=id_shards)
    two = ring_attention(*shards, mesh=mesh, causal=True,
                         segment_ids=[(s, s) for s in id_shards])
    for a, b in zip(one, two):
        assert torch.equal(a, b)
