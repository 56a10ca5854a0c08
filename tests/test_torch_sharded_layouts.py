"""The port's LM step in the zigzag layout and on packed batches against the
JAX package's ``make_sharded_train_step``.

On a (1, 1, 4) mesh -- the port's ``VirtualMesh`` of CPU ranks, the JAX
step under ``shard_map`` on the virtual devices of ``tests/conftest.py``
(Pallas in interpret mode) -- with the JAX ``init_transformer`` weights
carried over by ``models.convert.sharded_transformer_from_jax``, in f32 at
the width of tests/test_models.py: the lr=0 loss of the zigzag step and of a
packed step whose documents straddle the shard edges within 2e-3 of the JAX
step's and of the single-device ``lm_loss`` (the JAX tests' bound); the
zigzag step's gradients equal the contiguous step's.
"""

import numpy as np
import pytest
import torch

from flashattn_tpu_torch.models import transformer as T
from flashattn_tpu_torch.models.convert import sharded_transformer_from_jax, transformer_from_jax
from flashattn_tpu_torch.parallel import make_mesh
from flashattn_tpu_torch.utils.testing import BWD_TOL, assert_close

CFG = T.TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                          d_head=32, d_ff=128, dtype=torch.float32)
LOSS_TOL = 2e-3


@pytest.fixture(scope="module")
def jax_side():
    """The JAX config and the seed-0 weights of init_transformer (jax arrays
    and, for the port, numpy leaves); skips without 4 virtual devices."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models.transformer import TransformerConfig, init_transformer

    if jax.device_count() < 4:
        pytest.skip("needs 4 devices (virtual CPU mesh)")
    cfg = TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_head=32, d_ff=128, dtype=jnp.float32)
    params = init_transformer(jax.random.PRNGKey(0), cfg)
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _tokens(seed, B, N):
    return np.random.default_rng(seed).integers(0, 128, (B, N)).astype(np.int32)


def _jax_loss(cfg, params, tokens, *, seg=None, layout="contiguous"):
    """The lr=0 loss of one JAX sharded step on (1, 1, 4)."""
    import jax.numpy as jnp

    from flashattn_tpu.models.transformer import adamw_init, make_sharded_train_step
    from flashattn_tpu.parallel import make_mesh as jax_make_mesh

    step, _, _ = make_sharded_train_step(jax_make_mesh(seq=4), cfg, lr=0.0, seq_layout=layout,
                                         with_segment_ids=seg is not None)
    extra = () if seg is None else (jnp.asarray(seg),)
    return float(step(params, adamw_init(params), jnp.asarray(tokens), *extra)[2])


def test_zigzag_lm_step_loss_matches_jax(jax_side):
    """The LM step with seq_layout="zigzag": its lr=0 loss equals the JAX
    zigzag step's and the single-device lm_loss within 2e-3, and its
    gradients are the contiguous layout's (BWD_TOL[f32])."""
    cfg, params, np_params = jax_side
    tokens = _tokens(63, 2, 64)
    want = _jax_loss(cfg, params, tokens, layout="zigzag")
    mesh = make_mesh(seq=4, devices="cpu")
    losses, grads = [], []
    for layout in ("zigzag", "contiguous"):
        step, specs, _ = T.make_sharded_train_step(mesh, CFG, lr=0.0, seq_layout=layout)
        loss, g = step.loss_and_grads(sharded_transformer_from_jax(np_params, CFG, mesh),
                                      torch.from_numpy(tokens))
        losses.append(float(loss))
        grads.append({n: mesh.unshard([x[n] for x in g], specs[n]) for n in specs})
    with torch.no_grad():
        single = float(T.lm_loss(transformer_from_jax(np_params, CFG, device="cpu"),
                                 torch.from_numpy(tokens).long(), CFG))
    assert abs(losses[0] - want) < LOSS_TOL and abs(losses[0] - single) < LOSS_TOL
    for name in grads[0]:
        assert_close(grads[0][name], grads[1][name], BWD_TOL[torch.float32], name)


def test_packed_loss_with_a_straddling_document(jax_side):
    """Packed batches on (1, 1, 4): documents at [0, 25), [25, 49), [49, 64)
    straddle the 16-token shard edges; the loss equals the JAX packed step's
    and the single-device packed lm_loss."""
    cfg, params, np_params = jax_side
    tokens = _tokens(31, 2, 64)
    seg = np.broadcast_to((np.arange(64) >= 25).astype(np.int32)
                          + (np.arange(64) >= 49).astype(np.int32), (2, 64)).copy()
    want = _jax_loss(cfg, params, tokens, seg=seg)
    mesh = make_mesh(seq=4, devices="cpu")
    shards = sharded_transformer_from_jax(np_params, CFG, mesh)
    step, _, _ = T.make_sharded_train_step(mesh, CFG, lr=0.0, with_segment_ids=True)
    got = float(step(shards, [T.adamw_init(p) for p in shards], torch.from_numpy(tokens),
                     torch.from_numpy(seg))[2])
    with torch.no_grad():
        single = float(T.lm_loss(transformer_from_jax(np_params, CFG, device="cpu"),
                                 torch.from_numpy(tokens).long(), CFG,
                                 segment_ids=torch.from_numpy(seg)))
    assert abs(got - want) < LOSS_TOL, (got, want)
    assert abs(got - single) < LOSS_TOL, (got, single)
