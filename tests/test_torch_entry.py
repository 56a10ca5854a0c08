"""The port's entry points (flashattn_tpu_torch/entry.py) against the JAX ones
(__graft_entry__.py) on CPU.

``_factor_mesh`` is the JAX function's for n = 1..16. The dry run's per-mesh
``run`` on a CPU ``VirtualMesh`` gives the first-step loss of the JAX
``make_sharded_train_step`` on the same weights (the JAX ``init_transformer``
tree carried over) and tokens, in f32: at n = 4 contiguous and packed, and
at n = 8 on its two-slice mesh, within 2e-3 (the sharded LM tests' budget,
tests/test_torch_sharded_lm.py). The JAX sharded step runs on the 8 virtual
CPU devices of tests/conftest.py, its attention in interpret mode.

``entry()``'s U-Net costs ~25 s a side on this CPU, so the parity of the
denoise step runs on a narrower U-Net of the same structure (f32, residual
outputs not zero-initialised, so every block moves the output) within
FWD_TOL[f32]; at full size ``entry(device="cpu")`` is held to its shape,
dtype and the exact zeros of its zero-initialised outputs, as the JAX step
gives them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from flashattn_tpu_torch import entry as E
from flashattn_tpu_torch.models.convert import transformer_from_jax, unet_from_jax
from flashattn_tpu_torch.models.unet import UNetConfig
from flashattn_tpu_torch.parallel import make_mesh
from flashattn_tpu_torch.utils.testing import FWD_TOL, assert_close

LOSS_TOL = 2e-3


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_mesh_matches_jax(n):
    assert E._factor_mesh(n) == jax_entry._factor_mesh(n)


def _jax_run(n_devices, *, slices=1, packed=False):
    """The JAX dry run's ``run`` for ``n_devices`` (the two-slice mesh with
    ``slices=2``): its config's weights and tokens as numpy, and its loss."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models.transformer import (
        TransformerConfig, adamw_init, init_transformer, make_sharded_train_step)
    from flashattn_tpu.parallel import make_mesh as jax_make_mesh

    if jax.device_count() < n_devices:
        pytest.skip(f"needs {n_devices} devices (virtual CPU mesh)")
    data, model, seq = jax_entry._factor_mesh(n_devices)
    if slices == 2:
        s_model = max(1, model // 2) if seq * model >= 4 else model
        mesh = jax_make_mesh(data=1, model=s_model, seq=(n_devices // 2) // s_model, slices=2)
        data = 1
    else:
        mesh = jax_make_mesh(data=data, model=model, seq=seq)
    cfg = TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=2 * model,
                            n_kv_heads=model, d_head=32, d_ff=64 * model, dtype=jnp.float32)
    params = init_transformer(jax.random.PRNGKey(0), cfg)
    step, _, _ = make_sharded_train_step(mesh, cfg, lr=1e-3, with_segment_ids=packed)
    n = 128 * seq
    tokens = jax.random.randint(jax.random.PRNGKey(1), (max(2, 2 * data * slices), n), 0,
                                cfg.vocab_size)
    extra = ()
    if packed:
        seg = (jnp.arange(n)[None] >= n // 2 + 17).astype(jnp.int32)
        extra = (jnp.broadcast_to(seg, tokens.shape),)
    _, _, loss = step(params, adamw_init(params), tokens, *extra)
    return (jax.tree_util.tree_map(np.asarray, params), np.array(tokens), float(loss),
            (data, model, seq))


@pytest.mark.parametrize("n,slices,packed", [(4, 1, False), (4, 1, True), (8, 2, False)],
                         ids=["n4", "n4 packed", "n8 two slices"])
def test_dryrun_run_matches_the_jax_step(n, slices, packed):
    np_params, tokens, want, (data, model, seq) = _jax_run(n, slices=slices, packed=packed)
    if slices == 2:
        s_model = max(1, model // 2) if seq * model >= 4 else model
        mesh = make_mesh(data=1, model=s_model, seq=(n // 2) // s_model, slices=2,
                         devices="cpu")
    else:
        mesh = make_mesh(data=data, model=model, seq=seq, devices="cpu")
    lm = transformer_from_jax(np_params, E.lm_config(model), device="cpu")
    got = E.run(mesh, data, model, seq, slices=slices, packed=packed, lm=lm,
                tokens=torch.from_numpy(tokens).long())
    assert np.isfinite(got)
    assert abs(got - want) < LOSS_TOL, (got, want)


def test_dryrun_multichip_on_cpu_prints_its_meshes(capsys):
    """The whole dry run at n = 4 on a CPU VirtualMesh: two finite losses,
    one line each, as the JAX function prints them."""
    losses = E.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert len(losses) == 2 and all(np.isfinite(x) for x in losses)
    assert out[0].startswith("dryrun_multichip OK: mesh data=1 model=1 seq=4, loss=")
    assert out[1].startswith("dryrun_multichip OK (packed segment_ids): loss=")


# entry()'s structure (three levels, attention at each, 8 heads, a 768-wide
# context) at 32 base channels, f32, every residual output live.
NARROW = dataclasses.replace(E.entry_config(), model_channels=32, groups=8,
                             dtype=torch.float32, zero_init=False)


def test_entry_denoise_step_matches_jax_on_a_narrower_unet():
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models.unet import UNetConfig as JaxUNetConfig
    from flashattn_tpu.models.unet import init_unet, unet_forward

    jcfg = JaxUNetConfig(model_channels=32, channel_mult=(1, 2, 4), num_res_blocks=2,
                         attn_levels=(0, 1, 2), num_heads=8, context_dim=768, groups=8,
                         dtype=jnp.float32, zero_init=False)
    params = init_unet(jax.random.PRNGKey(0), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32, 4), jnp.float32)
    t = jnp.array([500.0])
    ctx = jax.random.normal(jax.random.PRNGKey(2), (1, 77, 768), jnp.float32)
    want = unet_forward(params, x, t, ctx, jcfg)
    fn, _ = E.entry(device="cpu", cfg=NARROW)
    unet = unet_from_jax(jax.tree_util.tree_map(np.asarray, params), NARROW, device="cpu")
    got = fn(unet, *(torch.from_numpy(np.array(a)) for a in (x, t, ctx)))
    assert got.shape == (1, 32, 32, 4) and got.dtype == torch.float32
    assert float(np.abs(np.asarray(want)).max()) > 1e-3  # every block moves the output
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])


def test_entry_full_size_on_cpu():
    """entry(device="cpu") at __graft_entry__'s config: the step's output is
    [1, 32, 32, 4] f32 and, its residual outputs zero-initialised as the JAX
    step's are, exactly 0."""
    fn, args = E.entry(device="cpu")
    assert isinstance(E.entry_config(), UNetConfig) and args[0].cfg == E.entry_config()
    out = fn(*args)
    assert out.shape == (1, 32, 32, 4) and out.dtype == torch.float32
    assert bool((out == 0).all())
