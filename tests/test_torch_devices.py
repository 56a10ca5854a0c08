"""The port's model entry points build on the card unless the caller asks for
the CPU.

Each of the ten entry points that allocates parameters or a cache takes
``device="cuda"`` by default. On a machine without CUDA (the CPU test run) a
call without a device raises torch's own error instead of falling back to the
CPU, and ``device="cpu"`` builds everything on the CPU. The inner modules (the
LM's ``Layer``, the U-Net's blocks, the attention module's projections) take
their device from their parent.
"""

import inspect

import numpy as np
import pytest
import torch

from flashattn_tpu_torch.integrations import torch_nn
from flashattn_tpu_torch.models import convert, transformer, unet

TCFG = transformer.TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                                     n_kv_heads=1, d_head=16, d_ff=64)
UCFG = unet.UNetConfig.tiny()


def _jax_tree(module):
    """A module's state as the JAX package's pytree would hold it: numpy
    leaves, U-Net conv kernels HWIO."""
    return {n: np.asarray((t.permute(2, 3, 1, 0) if t.ndim == 4 else t).float())
            for n, t in module.state_dict().items()}


ENTRY_POINTS = {
    "Transformer": (transformer.Transformer, lambda f, **kw: f(TCFG, **kw)),
    "init_transformer": (transformer.init_transformer,
                         lambda f, **kw: f(TCFG, torch.Generator().manual_seed(0), **kw)),
    "init_kv_cache": (transformer.init_kv_cache, lambda f, **kw: f(TCFG, 1, 4, **kw)),
    "UNet": (unet.UNet, lambda f, **kw: f(UCFG, **kw)),
    "init_unet": (unet.init_unet, lambda f, **kw: f(UCFG, torch.Generator().manual_seed(0), **kw)),
    "transformer_from_jax": (convert.transformer_from_jax, lambda f, **kw: f(
        _jax_tree(transformer.Transformer(TCFG, device="cpu")), TCFG, **kw)),
    "unet_from_jax": (convert.unet_from_jax, lambda f, **kw: f(
        _jax_tree(unet.UNet(UCFG, device="cpu")), UCFG, **kw)),
    "FlashMultiHeadDotProductAttention": (torch_nn.FlashMultiHeadDotProductAttention,
                                          lambda f, **kw: f(2, 16, **kw)),
    "mhdpa_from_flax": (convert.mhdpa_from_flax, lambda f, **kw: f(
        {"params": {name: {"kernel": np.zeros(shape, np.float32),
                           "bias": np.zeros(shape[-2:] if name != "out" else shape[-1:],
                                            np.float32)}
                    for name, shape in (("query", (16, 2, 8)), ("key", (16, 2, 8)),
                                        ("value", (16, 2, 8)), ("out", (2, 8, 16)))}},
        num_heads=2, **kw)),
    "kv_cache_from_jax": (convert.kv_cache_from_jax, lambda f, **kw: f(
        {"length": np.int32(3), "k": [np.zeros((1, 4, 1, 16), np.float32)],
         "v": [np.zeros((1, 4, 1, 16), np.float32)]}, **kw)),
}


def _tensors(obj):
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters())
    return [t for name in ("k", "v") for t in obj[name]]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call(fn)
    built = _tensors(call(fn, device="cpu"))
    assert built and all(t.device.type == "cpu" for t in built)
