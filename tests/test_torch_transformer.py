"""The port's LM (models/transformer.py), its AdamW step and its weight
converter against the JAX package's, in f32 on CPU.

Weights come from the JAX ``init_transformer`` at the tiny config of
tests/test_models.py and are carried over with ``transformer_from_jax``, so
both compute the same function on the same numpy tokens, unpacked and packed
(``segment_ids``: several documents per row), and with a sliding window or
logit soft-capping (``OPTIONS``). Attention is causal
``flash_attention`` in both: the JAX Pallas kernels in interpret mode, the
port's wrappers on their plain versions. Budgets: logits within FWD_TOL[f32]
(1e-4), parameter gradients within BWD_TOL[f32] (1e-3 abs + 5e-4 rel), the
AdamW update within 1e-6 (the same numpy gradients go into both, so only f32
rounding differs); packed against separate documents, logits within 2e-4 and
the loss within 1e-5, as tests/test_models.py checks the JAX model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import transformer as jax_lm
from flashattn_tpu_torch.models import transformer as lm
from flashattn_tpu_torch.models.convert import _flatten, transformer_from_jax
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, Tolerance, assert_close

WIDTH = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=32,
             d_ff=128)
JCFG = jax_lm.TransformerConfig(**WIDTH, dtype=jnp.float32)
PCFG = lm.TransformerConfig(**WIDTH, dtype=torch.float32)
TOKENS = np.random.default_rng(1).integers(0, 128, (2, 65)).astype(np.int32)
# Packed rows: three documents in row 0, two in row 1.
SEG = np.array([[0] * 20 + [1] * 25 + [2] * 20, [0] * 33 + [1] * 32], dtype=np.int32)
# The window binds over the 64 attended tokens; the cap bends the tiny LM's
# scores (up to ~3 here).
OPTIONS = {"sliding_window": dict(sliding_window=16), "logit_softcap": dict(logit_softcap=2.0)}


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_lm.init_transformer(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def jax_loss_and_grads(jax_params):
    loss, grads = jax.value_and_grad(lambda p: jax_lm.lm_loss(p, jnp.asarray(TOKENS), JCFG))(
        jax_params)
    return float(loss), dict(_flatten(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.fixture(scope="module")
def jax_packed_loss_and_grads(jax_params):
    loss, grads = jax.value_and_grad(lambda p: jax_lm.lm_loss(
        p, jnp.asarray(TOKENS), JCFG, segment_ids=jnp.asarray(SEG)))(jax_params)
    return float(loss), dict(_flatten(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.fixture(scope="module")
def jax_option_results(jax_params):
    """Per OPTIONS entry, the JAX model's logits, loss and gradients."""
    out = {}
    for name, kw in OPTIONS.items():
        jcfg = dataclasses.replace(JCFG, **kw)
        loss, grads = jax.value_and_grad(lambda p: jax_lm.lm_loss(p, jnp.asarray(TOKENS), jcfg))(
            jax_params)
        logits = jax_lm.transformer_forward(jax_params, jnp.asarray(TOKENS), jcfg)
        out[name] = (np.asarray(logits), float(loss),
                     dict(_flatten(jax.tree_util.tree_map(np.asarray, grads))))
    return out


def _tokens():
    return torch.from_numpy(TOKENS).long()


def _seg():
    return torch.from_numpy(SEG)


def _loss_and_grads(model, cfg=PCFG, attn_impl="fused", segment_ids=None):
    model.zero_grad(set_to_none=True)
    loss = lm.lm_loss(model, _tokens(), cfg, attn_impl=attn_impl, segment_ids=segment_ids)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_logits_and_loss_match_jax(jax_params, jax_loss_and_grads):
    model = transformer_from_jax(jax_params, PCFG, device="cpu")
    want = jax_lm.transformer_forward(jax_params, jnp.asarray(TOKENS), JCFG)
    with torch.no_grad():
        got = lm.transformer_forward(model, _tokens(), PCFG)
        assert torch.equal(model(_tokens()), got)
        loss = lm.lm_loss(model, _tokens(), PCFG)
    assert got.dtype == torch.float32 and got.shape == (2, 65, 128)
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32], "logits")
    assert abs(loss.item() - jax_loss_and_grads[0]) < 1e-5


def test_every_gradient_matches_jax(jax_params, jax_loss_and_grads):
    model = transformer_from_jax(jax_params, PCFG, device="cpu")
    loss, grads = _loss_and_grads(model)
    want = jax_loss_and_grads[1]
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        assert_close(g, want[name], BWD_TOL[torch.float32], name)


def test_adamw_update_matches_jax(jax_params):
    """Two steps on the same numpy gradients: parameters and both moments."""
    rng = np.random.default_rng(7)
    flat = dict(_flatten(jax_params))
    params = {n: torch.from_numpy(np.array(p)) for n, p in flat.items()}
    state = lm.adamw_init(params)
    j_params, j_state = jax_params, jax_lm.adamw_init(jax_params)
    for _ in range(2):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in flat.items()}
        j_grads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jax_params),
            [grads[n] for n, _ in _flatten(jax_params)])
        j_params, j_state = jax_lm.adamw_update(j_grads, j_state, j_params)
        params, state = lm.adamw_update({n: torch.from_numpy(g) for n, g in grads.items()},
                                        state, params)
    assert state["count"] == int(j_state["count"]) == 2
    tol = Tolerance(1e-6, 1e-6)
    for tree, got in ((j_params, params), (j_state["mu"], state["mu"]),
                      (j_state["nu"], state["nu"])):
        for name, want in _flatten(jax.tree_util.tree_map(np.asarray, tree)):
            assert got[name].dtype == torch.float32
            assert_close(got[name], want, tol, name)


def test_adamw_keeps_f32_moments_for_bf16_parameters():
    p = {"w": torch.tensor([1.0, -2.0, 3.0], dtype=torch.bfloat16)}
    state = lm.adamw_init(p)
    assert state["mu"]["w"].dtype == torch.float32 and state["count"] == 0
    g = torch.tensor([0.5, -0.25, 1e-3], dtype=torch.bfloat16)
    p, state = lm.adamw_update({"w": g}, state, p, lr=0.1)
    assert p["w"].dtype == torch.bfloat16
    want = (torch.tensor([1.0, -2.0, 3.0]) - 0.1 * (torch.sign(g.float()) + 0.01 * torch.tensor(
        [1.0, -2.0, 3.0]))).to(torch.bfloat16)
    assert torch.equal(p["w"], want)
    assert_close(state["mu"]["w"], 0.1 * g.float(), Tolerance(1e-7, 1e-6))


def test_attn_impl_fused_and_xla_agree(jax_params):
    """The two arms of the training step compute the same function."""
    model = transformer_from_jax(jax_params, PCFG, device="cpu")
    lf, gf = _loss_and_grads(model, attn_impl="fused")
    lx, gx = _loss_and_grads(model, attn_impl="xla")
    assert abs(lf - lx) < 1e-5
    for name in gf:
        assert_close(gf[name], gx[name], BWD_TOL[torch.float32], name)
    with pytest.raises(ValueError, match="attn_impl"):
        lm.lm_loss(model, _tokens(), PCFG, attn_impl="flash")


def test_remat_same_loss_and_grads(jax_params):
    """cfg.remat recomputes each block in the backward, never approximates."""
    model = transformer_from_jax(jax_params, PCFG, device="cpu")
    l0, g0 = _loss_and_grads(model)
    l1, g1 = _loss_and_grads(model, cfg=dataclasses.replace(PCFG, remat=True))
    assert abs(l0 - l1) < 1e-6
    assert max((g0[n] - g1[n]).abs().max().item() for n in g0) < 1e-5


def test_training_step_on_cpu_launches_no_kernel(jax_params):
    model = transformer_from_jax(jax_params, dataclasses.replace(PCFG, dtype=torch.bfloat16),
                                 device="cpu")
    params = dict(model.named_parameters())
    state = lm.adamw_init(params)
    before = (flash_fwd.fwd.launches, flash_bwd_fused.bwd.launches)
    losses = []
    for _ in range(3):
        model.zero_grad(set_to_none=True)
        loss = lm.lm_loss(model, _tokens(), model.cfg)
        loss.backward()
        lm.adamw_update({n: p.grad for n, p in params.items()}, state, params, lr=1e-2)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    assert (flash_fwd.fwd.launches, flash_bwd_fused.bwd.launches) == before


@pytest.mark.parametrize("option", ["sliding_window", "logit_softcap",
                                    "segment_ids+sliding_window"])
def test_unported_options_raise(jax_params, option):
    """The options that raised before the window and the softcap were ported
    now train: the fused arm's loss and gradients equal the xla arm's (the
    oracle with the same window and cap), also on a packed batch."""
    kw = {}
    if option.startswith("segment_ids+"):
        kw["segment_ids"] = _seg()
        option = option.split("+")[1]
    cfg = dataclasses.replace(PCFG, **{option: 16})
    model = transformer_from_jax(jax_params, cfg, device="cpu")
    lf, gf = _loss_and_grads(model, cfg, "fused", **kw)
    lx, gx = _loss_and_grads(model, cfg, "xla", **kw)
    l0, _ = _loss_and_grads(model, PCFG, "fused", **kw)
    assert abs(lf - lx) < 1e-5 and abs(lf - l0) > 1e-4  # the option changes the loss
    for name in gf:
        assert_close(gf[name], gx[name], BWD_TOL[torch.float32], name)


def test_init_transformer_mirrors_jax_tree(jax_params):
    model = lm.init_transformer(PCFG, torch.Generator().manual_seed(0), device="cpu")
    state = model.state_dict()
    flat = dict(_flatten(jax_params))
    assert state.keys() == flat.keys()
    for name, leaf in flat.items():
        assert tuple(state[name].shape) == leaf.shape, name
    assert torch.equal(model.ln_f, torch.ones(64)) and torch.equal(model.layers[1].ln2,
                                                                   torch.ones(64))
    assert abs(model.embed.std().item() - 0.02) < 2e-3
    assert abs(model.layers[0].w_down.std().item() * 128 ** 0.5 - 1) < 0.1


def test_transformer_from_jax_rejects_mismatched_tree(jax_params):
    bad = dict(jax_params)
    bad.pop("ln_f")
    with pytest.raises(ValueError, match="ln_f"):
        transformer_from_jax(bad, PCFG, device="cpu")
    bad = dict(jax_params, layers=[dict(layer) for layer in jax_params["layers"]])
    bad["layers"][1]["wq"] = bad["layers"][1]["wq"][:, :2]
    with pytest.raises(ValueError, match="layers.1.wq"):
        transformer_from_jax(bad, PCFG, device="cpu")


@pytest.mark.parametrize("ids", [[[0, 0, 1, 1, 1]], [[3, 3, 3, 0, 0, 7]], SEG[:, :40].tolist(),
                                 [[5] * 9]])
def test_segment_positions_match_jax(ids):
    ids = np.asarray(ids, dtype=np.int32)
    got = lm.segment_positions(torch.from_numpy(ids))
    assert np.array_equal(got.numpy(), np.asarray(jax_lm.segment_positions(jnp.asarray(ids))))


def test_packed_logits_and_loss_match_jax(jax_params, jax_packed_loss_and_grads):
    model = transformer_from_jax(jax_params, PCFG, device="cpu")
    want = jax_lm.transformer_forward(jax_params, jnp.asarray(TOKENS), JCFG,
                                      segment_ids=jnp.asarray(SEG))
    with torch.no_grad():
        got = lm.transformer_forward(model, _tokens(), PCFG, segment_ids=_seg())
        assert torch.equal(model(_tokens(), segment_ids=_seg()), got)
        loss = lm.lm_loss(model, _tokens(), PCFG, segment_ids=_seg())
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32], "logits")
    assert abs(loss.item() - jax_packed_loss_and_grads[0]) < 1e-5


def test_packed_gradients_match_jax(jax_params, jax_packed_loss_and_grads):
    model = transformer_from_jax(jax_params, PCFG, device="cpu")
    _, grads = _loss_and_grads(model, segment_ids=_seg())
    want = jax_packed_loss_and_grads[1]
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        assert_close(g, want[name], BWD_TOL[torch.float32], name)


def test_packed_batch_matches_separate_documents(jax_params):
    """Two documents packed into one row give the per-document logits, and a
    loss equal to the token-weighted mean of the separate losses (attention
    blocked across documents, RoPE restarted per document, boundary-masked
    loss)."""
    model = transformer_from_jax(jax_params, PCFG, device="cpu")
    n1, n2 = 28, 36
    toks = _tokens()[:1, :n1 + n2]
    seg = torch.cat([torch.zeros(1, n1, dtype=torch.int32), torch.ones(1, n2, dtype=torch.int32)], 1)
    with torch.no_grad():
        packed = lm.transformer_forward(model, toks, PCFG, segment_ids=seg)
        want = torch.cat([lm.transformer_forward(model, toks[:, :n1], PCFG),
                          lm.transformer_forward(model, toks[:, n1:], PCFG)], dim=1)
        lp = lm.lm_loss(model, toks, PCFG, segment_ids=seg).item()
        l1 = lm.lm_loss(model, toks[:, :n1], PCFG).item()
        l2 = lm.lm_loss(model, toks[:, n1:], PCFG).item()
    assert (packed - want).abs().max().item() < 2e-4
    assert abs(lp - ((n1 - 1) * l1 + (n2 - 1) * l2) / (n1 + n2 - 2)) < 1e-5


def test_packed_fused_and_xla_agree(jax_params):
    """The two arms of the packed training step compute the same function,
    and the packed step runs K1, K5 and K6's plain versions on the CPU (no
    kernel launch)."""
    model = transformer_from_jax(jax_params, PCFG, device="cpu")
    before = (flash_fwd.fwd.launches, flash_bwd_fused.bwd.launches, flash_bwd.split_bwd.launches,
              flash_bwd.bias_bwd.launches)
    lf, gf = _loss_and_grads(model, attn_impl="fused", segment_ids=_seg())
    lx, gx = _loss_and_grads(model, attn_impl="xla", segment_ids=_seg())
    assert abs(lf - lx) < 1e-5
    for name in gf:
        assert_close(gf[name], gx[name], BWD_TOL[torch.float32], name)
    assert (flash_fwd.fwd.launches, flash_bwd_fused.bwd.launches, flash_bwd.split_bwd.launches,
            flash_bwd.bias_bwd.launches) == before


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_windowed_and_softcapped_lm_match_jax(jax_params, jax_option_results, option):
    """The LM with a sliding window or a logit cap: logits, loss and every
    gradient against the JAX model with the same option."""
    cfg = dataclasses.replace(PCFG, **OPTIONS[option])
    model = transformer_from_jax(jax_params, cfg, device="cpu")
    logits, loss_want, grads_want = jax_option_results[option]
    with torch.no_grad():
        got = lm.transformer_forward(model, _tokens(), cfg)
    assert_close(got, logits, FWD_TOL[torch.float32], "logits")
    loss, grads = _loss_and_grads(model, cfg)
    assert abs(loss - loss_want) < 1e-5
    assert grads.keys() == grads_want.keys()
    for name, g in grads.items():
        assert_close(g, grads_want[name], BWD_TOL[torch.float32], name)


def test_remat_with_window_same_loss_and_grads(jax_params):
    """Remat recomputes the windowed blocks, never approximates."""
    cfg = dataclasses.replace(PCFG, sliding_window=16)
    model = transformer_from_jax(jax_params, cfg, device="cpu")
    l0, g0 = _loss_and_grads(model, cfg)
    l1, g1 = _loss_and_grads(model, cfg=dataclasses.replace(cfg, remat=True))
    assert abs(l0 - l1) < 1e-6
    assert max((g0[n] - g1[n]).abs().max().item() for n in g0) < 1e-5
