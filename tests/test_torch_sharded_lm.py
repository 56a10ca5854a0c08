"""The port's dp x tp x sp LM training step against the JAX package's.

``make_sharded_train_step`` of the port runs on a ``VirtualMesh`` of CPU
ranks (ring attention over ``seq`` on the plain versions of K1 / K3 / the
split route with offsets, psums over ``model``); the JAX step runs under
``shard_map`` on the 8 virtual devices of ``tests/conftest.py`` (Pallas in
interpret mode). Both take the same weights -- the JAX ``init_transformer``
tree carried over with ``models.convert.sharded_transformer_from_jax`` -- and
the same tokens, in f32 at the width of tests/test_models.py (two layers,
d_model 64, 4 / 2 heads of 32). The lr=0 loss agrees within 2e-3, as the
JAX tests hold theirs (the zigzag and packed steps: in
tests/test_torch_sharded_layouts.py).

The port's gradient is the true one (``jax.grad`` of the single-device JAX
``lm_loss``). The JAX step's is not, in two ways recorded in ROADMAP queue 3
as deviations of the reference and shown here by
``test_jax_step_gradients_deviate_from_the_true_gradient``: under
``shard_map(check_vma=False)`` the transpose of its loss psum is a psum, so
every gradient comes out multiplied by the size of the mesh (8 on a (2, 2,
2) mesh, where it psums over ``model`` too); and its per-leaf reduction
tests ``jax.tree_util.tree_leaves(spec)`` for "model", which a
PartitionSpec (a pytree leaf) never yields, so the gradients of the
tp-sharded leaves are psum'd over ``model`` as well -- each shard receives
the sum of every shard's gradient. AdamW hides the uniform factor, so one
lr=1e-3 step of both packages agrees on a mesh with ``model`` 1 and, on a
(2, 2, 2) mesh, on the replicated leaves.

The step applies ``cfg.sliding_window`` in the contiguous layout (its loss
and gradients are the single-device windowed ones) and refuses a window
under zigzag and any logit cap, which its ring cannot apply; the JAX step
drops the window silently, a third deviation of the reference
(``test_jax_step_drops_the_window``).
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
    and, for the port, numpy leaves)."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models.transformer import TransformerConfig, init_transformer

    cfg = TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_head=32, d_ff=128, dtype=jnp.float32)
    params = init_transformer(jax.random.PRNGKey(0), cfg)
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _need(n):
    import jax

    if jax.device_count() < n:
        pytest.skip(f"needs {n} devices (virtual CPU mesh)")


def _tokens(seed, B, N):
    return np.random.default_rng(seed).integers(0, 128, (B, N)).astype(np.int32)


def _jax_step(cfg, params, shape, tokens, *, lr, seg=None, layout="contiguous"):
    """One JAX sharded step: (new params, opt state, loss)."""
    import jax.numpy as jnp

    from flashattn_tpu.models.transformer import adamw_init, make_sharded_train_step
    from flashattn_tpu.parallel import make_mesh as jax_make_mesh

    _need(int(np.prod(shape)))
    step, _, _ = make_sharded_train_step(jax_make_mesh(*shape), cfg, lr=lr, seq_layout=layout,
                                         with_segment_ids=seg is not None)
    extra = () if seg is None else (jnp.asarray(seg),)
    return step(params, adamw_init(params), jnp.asarray(tokens), *extra)


def _port_step(np_params, shape, tokens, *, lr, seg=None, layout="contiguous"):
    """One port sharded step on a VirtualMesh: (mesh, shards, loss)."""
    mesh = make_mesh(*shape, devices="cpu")
    shards = sharded_transformer_from_jax(np_params, CFG, mesh)
    step, _, _ = T.make_sharded_train_step(mesh, CFG, lr=lr, seq_layout=layout,
                                           with_segment_ids=seg is not None)
    extra = () if seg is None else (torch.from_numpy(seg),)
    _, _, loss = step(shards, [T.adamw_init(p) for p in shards], torch.from_numpy(tokens),
                      *extra)
    return mesh, shards, float(loss)


def _global(mesh, shards, name):
    """A leaf gathered from the ranks' shards by its spec."""
    spec = T._param_specs(CFG)[name]
    return mesh.unshard([s[name] for s in shards], spec)


def _jax_leaf(tree, name):
    node = tree
    for part in name.split("."):
        node = node[int(part)] if part.isdigit() else node[part]
    return np.asarray(node)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 1, 4)], ids=["dp x tp x sp", "sp 4"])
def test_lr0_loss_matches_jax_and_single_device(jax_side, shape):
    cfg, params, np_params = jax_side
    tokens = _tokens(sum(shape), 2, 64)
    _, _, want = _jax_step(cfg, params, shape, tokens, lr=0.0)
    _, _, got = _port_step(np_params, shape, tokens, lr=0.0)
    with torch.no_grad():
        single = float(T.lm_loss(transformer_from_jax(np_params, CFG, device="cpu"),
                                 torch.from_numpy(tokens).long(), CFG))
    assert abs(got - float(want)) < LOSS_TOL, (got, float(want))
    assert abs(got - single) < LOSS_TOL, (got, single)


@pytest.mark.parametrize("shape,seg", [((2, 2, 2), False), ((1, 2, 4), True)],
                         ids=["dp x tp x sp", "tp x sp packed"])
def test_sharded_grads_are_the_true_gradient(jax_side, shape, seg):
    """The step's per-rank gradients (step.loss_and_grads), gathered to
    global leaves by their specs, against jax.grad of the single-device JAX
    lm_loss on the same weights and tokens (BWD_TOL[f32])."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models.transformer import lm_loss

    cfg, params, np_params = jax_side
    tokens = _tokens(7, 2, 64)
    ids = None
    if seg:
        ids = np.broadcast_to((np.arange(64) >= 21).astype(np.int32), (2, 64)).copy()
    mesh = make_mesh(*shape, devices="cpu")
    shards = sharded_transformer_from_jax(np_params, CFG, mesh)
    step, _, _ = T.make_sharded_train_step(mesh, CFG, with_segment_ids=seg)
    _, grads = step.loss_and_grads(shards, torch.from_numpy(tokens),
                                   None if ids is None else torch.from_numpy(ids))
    kw = {} if ids is None else {"segment_ids": jnp.asarray(ids)}
    want = jax.grad(lm_loss)(params, jnp.asarray(tokens), cfg, **kw)
    for name in T._param_specs(CFG):
        got = mesh.unshard([g[name] for g in grads], T._param_specs(CFG)[name])
        assert_close(got, _jax_leaf(want, name), BWD_TOL[torch.float32], name)


def test_one_adamw_step_matches_jax(jax_side):
    """One lr=1e-3 step from the same weights on (1, 1, 4): the port's
    update of every leaf is the JAX step's. AdamW's first step moves a leaf
    by lr (g / (|g| + eps) + wd p), which cancels the JAX gradient's uniform
    factor s = 4 except where |g| nears eps = 1e-8: the JAX parameters are
    the port's minus lr (s g / (s |g| + eps) - g / (|g| + eps)), g the
    port's gradient: within 1e-6 where |g| >= 10 eps (below, the slope of
    g / (|g| + eps) magnifies the f32 rounding between the two gradients),
    and within lr / 2 everywhere."""
    cfg, params, np_params = jax_side
    tokens = _tokens(8, 2, 64)
    new, _, _ = _jax_step(cfg, params, (1, 1, 4), tokens, lr=1e-3)
    mesh, shards, _ = _port_step(np_params, (1, 1, 4), tokens, lr=1e-3)
    step, specs, _ = T.make_sharded_train_step(mesh, CFG)
    _, grads = step.loss_and_grads(sharded_transformer_from_jax(np_params, CFG, mesh),
                                   torch.from_numpy(tokens))
    lr, eps, factor = 1e-3, 1e-8, 4.0
    for name in specs:
        g = mesh.unshard([x[name] for x in grads], specs[name]).double()
        shift = lr * (factor * g / (factor * g.abs() + eps) - g / (g.abs() + eps))
        diff = np.abs((_global(mesh, shards, name).double() - shift).numpy()
                      - _jax_leaf(new, name))
        assert diff[g.abs().numpy() >= 10 * eps].max() <= 1e-6 and diff.max() <= lr / 2, name
        moved = _global(mesh, shards, name).numpy() - _jax_leaf(np_params, name)
        assert np.abs(moved).max() > 5e-4, name


def test_jax_step_gradients_deviate_from_the_true_gradient(jax_side):
    """The reference's two deviations on a (2, 2, 2) mesh, read from the JAX
    step's AdamW first moment (mu = 0.1 g after one step): a replicated
    leaf's g is 8x the true gradient; a tp-sharded leaf's g is the same on
    both model shards (each received the sum of both shards' gradients).
    The port's step moves the replicated leaves as the JAX step does, up to
    lr / 2 where |g| nears AdamW's eps."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models.transformer import lm_loss

    cfg, params, np_params = jax_side
    tokens = _tokens(9, 2, 64)
    new, opt, _ = _jax_step(cfg, params, (2, 2, 2), tokens, lr=1e-3)
    true = jax.grad(lm_loss)(params, jnp.asarray(tokens), cfg)
    g = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, opt["mu"])
    for name in ("embed", "ln_f", "layers.0.ln1", "layers.1.ln2"):
        assert_close(_jax_leaf(g, name), 8 * _jax_leaf(true, name), BWD_TOL[torch.float32],
                     name)
    wq = _jax_leaf(g, "layers.0.wq")  # [64, 4 heads, 32], heads sharded on model
    assert np.array_equal(wq[:, :2], wq[:, 2:])
    true_wq = _jax_leaf(true, "layers.0.wq")
    assert_close(wq[:, :2] / 8, true_wq[:, :2] + true_wq[:, 2:], BWD_TOL[torch.float32], "wq")
    mesh, shards, _ = _port_step(np_params, (2, 2, 2), tokens, lr=1e-3)
    for name in ("embed", "ln_f", "layers.0.ln1", "layers.1.ln2"):
        diff = np.abs(_global(mesh, shards, name).numpy() - _jax_leaf(new, name))
        assert diff.max() <= 5e-4, name  # lr / 2: the eps term of the factor 8


def test_loss_falls_over_three_steps():
    """Memorizing one batch on (2, 2, 2): the loss falls over 3 lr=1e-3
    steps (tests/test_models.py:151-161)."""
    mesh = make_mesh(2, 2, 2, devices="cpu")
    model = T.init_transformer(CFG, torch.Generator().manual_seed(3), device="cpu")
    shards = T.shard_params(model, mesh)
    opt = [T.adamw_init(p) for p in shards]
    step, pspecs, opt_specs = T.make_sharded_train_step(mesh, CFG, lr=1e-3)
    assert pspecs["layers.0.wq"] == (None, "model", None) and opt_specs["mu"] is pspecs
    tokens = torch.from_numpy(_tokens(10, 4, 64)).long()
    losses = [float(step(shards, opt, tokens)[2]) for _ in range(4)]
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(losses))


def test_step_rejections():
    """The JAX ValueErrors: an unknown layout, packed batches with zigzag;
    a packed step called without ids raises TypeError."""
    mesh = make_mesh(seq=4, devices="cpu")
    with pytest.raises(ValueError, match="unknown seq_layout"):
        T.make_sharded_train_step(mesh, CFG, seq_layout="striped")
    with pytest.raises(ValueError, match="contiguous"):
        T.make_sharded_train_step(mesh, CFG, seq_layout="zigzag", with_segment_ids=True)
    step, _, _ = T.make_sharded_train_step(mesh, CFG, with_segment_ids=True)
    with pytest.raises(TypeError, match="segment_ids"):
        step([], [], torch.zeros(1, 64, dtype=torch.long))


# Fault 4: a window of 4 tokens, whose rows reach across the 16-token seq
# shards of a (1, 2, 4) mesh at their first rows; at these weights it moves
# the loss by 1.6e-2 to 1.8e-2, past twice LOSS_TOL, so a dropped window
# fails the loss gate.
WINDOW = 4


@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed"])
def test_windowed_sharded_step_is_the_single_device_loss(jax_side, packed):
    """The contiguous step applies cfg.sliding_window as the ring's window
    (sliding_window - 1, -1) in global positions: its loss is the
    single-device lm_loss with the window, the port's and the JAX
    package's, within LOSS_TOL -- and not the loss without it -- and its
    gradients are jax.grad of the JAX lm_loss with the window (BWD_TOL[f32]);
    with packed documents too."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models.transformer import lm_loss

    cfg, params, np_params = jax_side
    jcfg = dataclasses.replace(cfg, sliding_window=WINDOW)
    pcfg = dataclasses.replace(CFG, sliding_window=WINDOW)
    tokens = _tokens(11, 2, 64)
    ids = None
    if packed:
        ids = np.broadcast_to((np.arange(64) >= 37).astype(np.int32), (2, 64)).copy()
    mesh = make_mesh(1, 2, 4, devices="cpu")
    step, specs, _ = T.make_sharded_train_step(mesh, pcfg, with_segment_ids=packed)
    ids_t = None if ids is None else torch.from_numpy(ids)
    loss, grads = step.loss_and_grads(sharded_transformer_from_jax(np_params, pcfg, mesh),
                                      torch.from_numpy(tokens), ids_t)
    model = transformer_from_jax(np_params, pcfg, device="cpu")
    with torch.no_grad():
        single = float(T.lm_loss(model, torch.from_numpy(tokens).long(), pcfg,
                                 segment_ids=ids_t))
        unwindowed = float(T.lm_loss(model, torch.from_numpy(tokens).long(), CFG,
                                     segment_ids=ids_t))
    kw = {} if ids is None else {"segment_ids": jnp.asarray(ids)}
    want_loss, want = jax.value_and_grad(lm_loss)(params, jnp.asarray(tokens), jcfg, **kw)
    assert abs(float(loss) - single) < LOSS_TOL, (float(loss), single)
    assert abs(float(loss) - float(want_loss)) < LOSS_TOL, (float(loss), float(want_loss))
    assert abs(single - unwindowed) > 2 * LOSS_TOL  # the window binds
    for name in specs:
        got = mesh.unshard([g[name] for g in grads], specs[name])
        assert_close(got, _jax_leaf(want, name), BWD_TOL[torch.float32], name)


@pytest.mark.parametrize("opts,layout,match", [
    ({"sliding_window": WINDOW}, "zigzag", "sliding_window"),
    ({"logit_softcap": 30.0}, "contiguous", "logit_softcap"),
    ({"logit_softcap": 30.0, "sliding_window": WINDOW}, "zigzag", "logit_softcap")],
    ids=["zigzag window", "cap", "zigzag cap"])
def test_sharded_step_refuses_what_its_ring_cannot_apply(opts, layout, match):
    """The zigzag ring is causal only and neither package's ring takes a
    logit cap: the step raises, naming the option, when it is built."""
    import dataclasses

    mesh = make_mesh(1, 1, 2, devices="cpu")
    with pytest.raises(ValueError, match=match):
        T.make_sharded_train_step(mesh, dataclasses.replace(CFG, **opts), seq_layout=layout)


def test_jax_step_drops_the_window(jax_side):
    """A deviation of the reference (ROADMAP queue 3): the JAX step calls its
    ring with causal=True alone, so with a sliding window its lr=0 loss is
    the loss without one, not the JAX lm_loss with the window."""
    import dataclasses

    import jax.numpy as jnp

    from flashattn_tpu.models.transformer import lm_loss

    cfg, params, _ = jax_side
    jcfg = dataclasses.replace(cfg, sliding_window=WINDOW)
    tokens = _tokens(12, 2, 64)
    _, _, windowed = _jax_step(jcfg, params, (1, 1, 4), tokens, lr=0.0)
    _, _, plain = _jax_step(cfg, params, (1, 1, 4), tokens, lr=0.0)
    true = float(lm_loss(params, jnp.asarray(tokens), jcfg))
    assert abs(float(windowed) - float(plain)) < 1e-5
    assert abs(float(windowed) - true) > 2 * LOSS_TOL
