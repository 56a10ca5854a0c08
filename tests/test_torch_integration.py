"""The port's torch.nn integration (integrations/torch_nn.py) against flax on CPU.

Ports the 8 tests of tests/test_flax_integration.py: every one holds the
port's fused path (plain versions of K1, K3 / K5 / K6 on CPU tensors) against
flax's own ``nn.dot_product_attention`` / ``nn.MultiHeadDotProductAttention``
on the same numpy inputs, the module's weights carried across from flax by
``models.convert.mhdpa_from_flax``. Budgets: the JAX tests' (2e-5 on outputs,
5e-4 on parameter gradients), as max-abs differences.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu_torch.integrations import (
    FlashMultiHeadDotProductAttention,
    flash_attention_fn,
    make_attention_mask,
    make_flash_attention_fn,
)
from flashattn_tpu_torch.models.convert import mhdpa_from_flax


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for _ in range(3))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _maxdiff(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.max(np.abs(a - np.asarray(b))))


def _flax_params(module, x, seed):
    return jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(seed),
                                                          jnp.asarray(x)))


def test_matches_flax_dot_product_attention():
    q, k, v = _qkv(0, (2, 192, 4, 32))
    ours = flash_attention_fn(*_t(q, k, v), impl="fused")
    assert _maxdiff(ours, nn.dot_product_attention(q, k, v)) < 2e-5


def test_bool_mask_and_bias():
    q, k, v = _qkv(1, (1, 128, 2, 32))
    rng = np.random.default_rng(2)
    # keep at least the diagonal so no row is fully masked
    mask = (rng.random((1, 1, 128, 128)) < 0.9) | np.eye(128, dtype=bool)[None, None]
    bias = 0.3 * rng.standard_normal((1, 2, 128, 128), dtype=np.float32)
    ours = flash_attention_fn(*_t(q, k, v, bias, mask), impl="fused")
    want = nn.dot_product_attention(q, k, v, bias=bias, mask=mask)
    assert _maxdiff(ours, want) < 2e-5


def test_causal_binding_matches_materialized_mask():
    q, k, v = _qkv(4, (2, 160, 4, 32))
    ours = make_flash_attention_fn(causal=True, impl="fused")(*_t(q, k, v))
    want = nn.dot_product_attention(q, k, v, mask=nn.make_causal_mask(jnp.ones((2, 160))))
    assert _maxdiff(ours, want) < 2e-5


def test_extra_batch_dims():
    q, k, v = _qkv(5, (2, 3, 96, 2, 32))
    ours = flash_attention_fn(*_t(q, k, v), impl="fused")
    want = nn.dot_product_attention(q, k, v)
    assert tuple(ours.shape) == want.shape
    assert _maxdiff(ours, want) < 2e-5


def test_dropout_rejected():
    q, k, v = _t(*_qkv(6, (1, 64, 2, 32)))
    with pytest.raises(NotImplementedError, match="dropout"):
        flash_attention_fn(q, k, v, dropout_rate=0.1, deterministic=False)
    # deterministic=True ignores the rate (flax eval-mode convention)
    assert flash_attention_fn(q, k, v, dropout_rate=0.1, deterministic=True).shape == q.shape


def test_mhdpa_module_hook():
    """Full module: flax's weights carried across, the core swapped for the
    fused kernels, nothing changes numerically."""
    x = np.random.default_rng(7).standard_normal((2, 128, 64), dtype=np.float32)
    ref = nn.MultiHeadDotProductAttention(num_heads=4)
    params = _flax_params(ref, x, 8)
    ours = mhdpa_from_flax(params, num_heads=4, impl="fused", device="cpu")
    assert _maxdiff(ours(torch.from_numpy(x)), ref.apply(params, x)) < 2e-5


def test_mhdpa_module_grads():
    x = np.random.default_rng(9).standard_normal((1, 96, 32), dtype=np.float32)
    ref = nn.MultiHeadDotProductAttention(num_heads=2)
    params = _flax_params(ref, x, 10)
    mod = mhdpa_from_flax(params, num_heads=2, causal=True, impl="fused", device="cpu")
    (mod(torch.from_numpy(x)) ** 2).sum().backward()
    causal = nn.make_causal_mask(jnp.ones((1, 96)))
    g_want = jax.grad(lambda p: (ref.apply(p, x, mask=causal) ** 2).sum())(params)["params"]
    grads = dict(mod.named_parameters())
    for proj, leaves in g_want.items():
        for leaf, want in leaves.items():
            assert _maxdiff(grads[f"{proj}.{leaf}"].grad, want) < 5e-4, f"{proj}.{leaf}"


def test_flash_mhdpa_subclass():
    x = np.random.default_rng(11).standard_normal((1, 128, 64), dtype=np.float32)
    ref = nn.MultiHeadDotProductAttention(num_heads=4)
    params = _flax_params(ref, x, 12)
    mod = mhdpa_from_flax(params, num_heads=4, causal=True, device="cpu")
    assert isinstance(mod, FlashMultiHeadDotProductAttention)
    want = ref.apply(params, x, mask=nn.make_causal_mask(jnp.ones((1, 128))))
    assert _maxdiff(mod(torch.from_numpy(x)), want) < 2e-5


def test_padding_mask_module_matches_flax_on_valid_rows():
    """Path A of the card's smoke test at a small size: a key-padding mask
    from row lengths (make_attention_mask, boolean) through the module,
    cross-attention widths (qkv_features != in_features), against flax on the
    rows that have keys to attend; the padded rows follow the package's
    dead-row convention (zeros through the output projection: its bias)."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 80, 48), dtype=np.float32)
    valid = np.arange(80)[None] < np.array([[80], [50], [20]])
    ref = nn.MultiHeadDotProductAttention(num_heads=4, qkv_features=64, out_features=40)
    params = _flax_params(ref, x, 14)
    params["params"]["out"]["bias"] = rng.standard_normal(40).astype(np.float32)
    mod = mhdpa_from_flax(params, num_heads=4, impl="fused", device="cpu")
    mask = make_attention_mask(torch.from_numpy(valid), torch.from_numpy(valid), dtype=torch.bool)
    got = mod(torch.from_numpy(x), mask=mask).detach().numpy()
    want = np.asarray(ref.apply(params, x, mask=nn.make_attention_mask(valid, valid)))
    assert _maxdiff(got[valid], want[valid]) < 2e-5
    np.testing.assert_array_equal(got[~valid], np.broadcast_to(
        params["params"]["out"]["bias"], got[~valid].shape))


@pytest.mark.parametrize("padded", [False, True])
def test_learned_bias_module_grads_match_flax(padded):
    """The smoke test's learned-bias trainer at a small size: a trainable
    relative-position bias [1, H, N, N] passed to the module (with and
    without a key-padding mask) gets the gradient that jax.grad gives flax's
    module with that bias bound into nn.dot_product_attention, and so do the
    projections; the loss counts the valid rows only."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 64, 32), dtype=np.float32)
    rel = 0.5 * rng.standard_normal((1, 2, 64, 64), dtype=np.float32)
    valid = np.arange(64)[None] < np.array([[64], [40 if padded else 64]])
    mask = nn.make_attention_mask(valid, valid) if padded else None

    def ref(b):
        return nn.MultiHeadDotProductAttention(
            num_heads=2, attention_fn=functools.partial(nn.dot_product_attention, bias=b))

    params = _flax_params(ref(rel), x, 18)

    def loss_jax(p, b):
        y = ref(b).apply(p, x, mask=mask)
        return ((y ** 2) * valid[..., None]).sum()

    g_params, g_rel = jax.grad(loss_jax, argnums=(0, 1))(params, jnp.asarray(rel))
    mod = mhdpa_from_flax(params, num_heads=2, impl="fused", device="cpu")
    rel_t = torch.from_numpy(rel).requires_grad_(True)
    tmask = None if mask is None else torch.from_numpy(np.array(mask)).bool()
    y = mod(torch.from_numpy(x), mask=tmask, bias=rel_t)
    ((y ** 2) * torch.from_numpy(valid)[..., None]).sum().backward()
    assert _maxdiff(y[torch.from_numpy(valid)], np.asarray(
        ref(rel).apply(params, x, mask=mask))[valid]) < 2e-5
    assert rel_t.grad.shape == rel_t.shape
    assert _maxdiff(rel_t.grad, g_rel) < 5e-4
    grads = dict(mod.named_parameters())
    for proj, leaves in g_params["params"].items():
        for leaf, want in leaves.items():
            assert _maxdiff(grads[f"{proj}.{leaf}"].grad, want) < 5e-4, f"{proj}.{leaf}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bool])
def test_make_attention_mask_matches_flax(dtype):
    valid = np.random.default_rng(15).random((2, 3, 17)) < 0.7
    got = make_attention_mask(torch.from_numpy(valid), torch.from_numpy(valid[..., :11]),
                              dtype=dtype)
    want = np.asarray(nn.make_attention_mask(valid, valid[..., :11]))
    assert got.dtype == dtype and tuple(got.shape) == want.shape == (2, 3, 1, 17, 11)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_mhdpa_from_flax_carries_every_leaf():
    """Every flax leaf lands in the module's parameter of the same path, cast
    to the module's dtype; a tree that differs is refused."""
    x = np.zeros((1, 8, 24), dtype=np.float32)
    params = _flax_params(nn.MultiHeadDotProductAttention(num_heads=3), x, 16)
    mod = mhdpa_from_flax(params, num_heads=3, dtype=torch.bfloat16, device="cpu")
    state = mod.state_dict()
    leaves = {f"{p}.{n}": w for p, d in params["params"].items() for n, w in d.items()}
    assert state.keys() == leaves.keys()
    for name, w in leaves.items():
        assert state[name].dtype == torch.bfloat16
        assert torch.equal(state[name], torch.from_numpy(np.array(w)).to(torch.bfloat16)), name
    del params["params"]["key"]["bias"]
    with pytest.raises(ValueError, match="differ"):
        mhdpa_from_flax(params, num_heads=3, device="cpu")
