"""The port's U-Net and Euler sampler against the JAX package's, in f32 on CPU.

Weights come from the JAX ``init_unet`` and are carried over with
``unet_from_jax``, so both compute the same function on the same numpy
inputs. At ``UNetConfig.tiny()`` and a 48x48 latent the level-0
self-attention has N = 2304 > 1536, so the SDPA adapter's rule sends it to
the fused route: the JAX Pallas kernel in interpret mode, and the port's K1
wrapper (its plain version on CPU). Everything runs in f32, and the budget is
FWD_TOL[f32] (1e-4 abs + 1e-4 rel), the package's f32 attention budget: the
port's only differences are summation orders (measured ~3e-6 on O(1) eps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import diffusion as jax_diffusion
from flashattn_tpu.models import unet as jax_unet
from flashattn_tpu_torch.models import diffusion, unet
from flashattn_tpu_torch.models.convert import _flatten, unet_from_jax
from flashattn_tpu_torch.ops import flash_fwd
from flashattn_tpu_torch.utils.testing import FWD_TOL, Tolerance, assert_close

TOL = FWD_TOL[torch.float32]
JCFG = jax_unet.UNetConfig.tiny()
PCFG = unet.UNetConfig.tiny()


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_unet.init_unet(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def port_unet(jax_params):
    return unet_from_jax(jax_params, PCFG, device="cpu")


def _inputs(seed, size, batch=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, 4), dtype=np.float32)
    ctx = rng.standard_normal((batch, 8, PCFG.context_dim), dtype=np.float32)
    t = rng.uniform(0, 999, batch).astype(np.float32)
    return x, t, ctx


def _port_forward(model, x, t, ctx, attn_impl):
    with torch.no_grad():
        return unet.unet_forward(model, torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(ctx), PCFG, attn_impl=attn_impl)


def test_unet_forward_fused_route_matches_jax(jax_params, port_unet):
    """48x48: level-0 self-attention (N=2304) takes the fused route in both."""
    x, t, ctx = _inputs(1, 48)
    want = jax_unet.unet_forward(jax_params, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(ctx), JCFG)
    before = flash_fwd.fwd.launches
    got = _port_forward(port_unet, x, t, ctx, "fused")
    assert flash_fwd.fwd.launches == before  # CPU tensors never launch the kernel
    assert got.dtype == torch.float32 and got.shape == (1, 48, 48, 4)
    assert_close(got, np.asarray(want), TOL)


def test_unet_forward_xla_arm_matches_jax(jax_params, port_unet):
    x, t, ctx = _inputs(2, 16, batch=2)
    want = jax_unet.unet_forward(jax_params, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(ctx), JCFG, attn_impl="xla")
    got = _port_forward(port_unet, x, t, ctx, "xla")
    assert_close(got, np.asarray(want), TOL)
    with torch.no_grad():  # the module call is unet_forward with the module's config
        called = port_unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                           attn_impl="xla")
    assert torch.equal(called, got)
    with pytest.raises(ValueError, match="attn_impl"):
        _port_forward(port_unet, x, t, ctx, "flash")


def test_euler_sample_matches_jax(jax_params, port_unet):
    """3 Euler steps at 16x16 from JAX's own noise draw."""
    shape = (1, 16, 16, 4)
    key = jax.random.PRNGKey(6)
    ctx = np.random.default_rng(5).standard_normal((1, 8, 32), dtype=np.float32)
    want = jax_diffusion.euler_sample(jax_params, key, jnp.asarray(ctx), cfg=JCFG,
                                      shape=shape, steps=3)
    noise = torch.from_numpy(np.array(jax.random.normal(key, shape)))
    got = diffusion.euler_sample(port_unet, torch.from_numpy(ctx), cfg=PCFG, shape=shape,
                                 steps=3, noise=noise)
    assert got.dtype == torch.float32 and got.shape == shape
    assert_close(got, np.asarray(want), TOL)


def test_euler_sample_generator_and_noise_shape(port_unet):
    ctx = torch.zeros(1, 8, 32)
    shape = (1, 8, 8, 4)
    a, b = (diffusion.euler_sample(port_unet, ctx, cfg=PCFG, shape=shape, steps=2,
                                   generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="noise shape"):
        diffusion.euler_sample(port_unet, ctx, cfg=PCFG, shape=shape, steps=2,
                               noise=torch.zeros(1, 8, 8, 3))


def test_karras_sigmas_and_timesteps_match_jax():
    for n in (3, 20):
        s = diffusion.karras_sigmas(n)
        assert s.dtype == torch.float32 and s.shape == (n + 1,) and s[-1] == 0
        assert_close(s, np.asarray(jax_diffusion.karras_sigmas(n)), Tolerance(1e-6, 1e-6))
        assert_close(diffusion.sigma_to_t(s), np.asarray(jax_diffusion.sigma_to_t(
            jnp.asarray(s.numpy()))), Tolerance(1e-4, 1e-6))


@pytest.mark.parametrize("size,stride,ksize", [(8, 2, 3), (7, 2, 3), (6, 1, 3), (5, 1, 1)])
def test_conv_same_padding_matches_jax(size, stride, ksize):
    """``padding="SAME"``: a stride-2 3x3 conv on an even size pads (0, 1),
    where torch's symmetric padding=1 would shift the output by a pixel."""
    rng = np.random.default_rng(size * 10 + stride)
    x = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    w_hwio = rng.standard_normal((ksize, ksize, 3, 5), dtype=np.float32)
    b = rng.standard_normal(5, dtype=np.float32)
    want = jax_unet._conv({"w": jnp.asarray(w_hwio), "b": jnp.asarray(b)}, jnp.asarray(x),
                          stride=stride)
    conv = unet.Conv(3, 5, ksize, torch.float32)
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy(w_hwio).permute(3, 2, 0, 1))
        conv.b.copy_(torch.from_numpy(b))
        got = conv(torch.from_numpy(x), stride=stride)
    assert got.shape == want.shape
    assert_close(got, np.asarray(want), Tolerance(1e-5, 1e-5))


def test_gelu_is_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = unet._gelu_f32(torch.from_numpy(x))
    assert_close(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), Tolerance(1e-6, 1e-6))
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert (got - exact).abs().max() > 1e-4  # the erf form is a different function


def test_nearest_upsample_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 5, 3, 4), dtype=np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 10, 6, 4), "nearest")
    got = unet._upsample_nearest2x(torch.from_numpy(x))
    assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_norms_and_timestep_embedding_match_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 6, 6, 16), dtype=np.float32) * 3 + 1
    scale = rng.standard_normal(16, dtype=np.float32)
    bias = rng.standard_normal(16, dtype=np.float32)
    norm = unet.Norm(16)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tol = Tolerance(1e-5, 1e-5)
    assert_close(unet._group_norm(torch.from_numpy(x), norm, 4),
                 np.asarray(jax_unet._group_norm(jnp.asarray(x), p, 4)), tol, "group_norm")
    assert_close(unet._layer_norm(torch.from_numpy(x), norm),
                 np.asarray(jax_unet._layer_norm(jnp.asarray(x), p)), tol, "layer_norm")
    t = np.array([0.0, 1.5, 500.0, 999.0], np.float32)
    assert_close(unet.timestep_embedding(torch.from_numpy(t), 32),
                 np.asarray(jax_unet.timestep_embedding(jnp.asarray(t), 32)),
                 Tolerance(1e-5, 1e-5), "temb")


def test_conv_weights_carried_hwio_to_oihw(jax_params, port_unet):
    """``unet_from_jax`` transposes conv kernels HWIO -> OIHW; the first up
    ResBlock takes ``[h, skip]``, twice the deepest width."""
    blk = port_unet.ups[0]["blocks"][0]["res"]
    ch = PCFG.model_channels * PCFG.channel_mult[-1]
    assert blk.skip.w.shape[1] == 2 * ch
    jw = jax_params["ups"][0]["blocks"][0]["res"]["skip"]["w"]
    assert torch.equal(blk.skip.w, torch.from_numpy(np.array(jw)).permute(3, 2, 0, 1))


def test_init_unet_mirrors_jax_tree(jax_params):
    cfg = dataclasses.replace(PCFG, zero_init=True)
    model = unet.init_unet(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat = dict(_flatten(jax_params))
    state = model.state_dict()
    assert state.keys() == flat.keys()
    for name, leaf in flat.items():
        want = leaf.shape if leaf.ndim != 4 else tuple(leaf.shape[i] for i in (3, 2, 0, 1))
        assert tuple(state[name].shape) == want, name
    # SD zero-init: the output conv, every ResBlock's conv2 and every proj_out
    assert not model.conv_out.w.any() and not model.mid["res1"].conv2.w.any()
    assert not model.mid["attn"].proj_out.w.any()
    assert model.conv_in.w.std() > 0 and model.mid["attn"].proj_in.w.any()
    fan_in = 3 * 3 * PCFG.in_channels
    assert abs(model.conv_in.w.std().item() * fan_in ** 0.5 - 1) < 0.3


def test_unet_from_jax_rejects_mismatched_tree(jax_params):
    bad = dict(jax_params)
    bad.pop("conv_out")
    with pytest.raises(ValueError, match="conv_out"):
        unet_from_jax(bad, PCFG, device="cpu")
