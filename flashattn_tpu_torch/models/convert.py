"""Carry U-Net and LM weights, LM KV caches, and a flax attention module's
weights from the JAX side to the port. Each builds on the card unless given
``device=``.

The JAX trees (``init_unet`` of flashattn_tpu/models/unet.py,
``init_transformer`` of flashattn_tpu/models/transformer.py; leaves as numpy
arrays) and the port's :class:`UNet` and :class:`Transformer` have the same
paths; only U-Net conv kernels change layout, HWIO -> OIHW. With the weights
carried over, both compute the same function, which is how the tests hold the
port to the JAX models. A KV cache of the JAX ``init_kv_cache`` /
``decode_step`` carries over with :func:`kv_cache_from_jax`.
"""

from __future__ import annotations

import numpy as np
import torch

from flashattn_tpu_torch.integrations.torch_nn import FlashMultiHeadDotProductAttention
from flashattn_tpu_torch.models.transformer import Transformer, TransformerConfig
from flashattn_tpu_torch.models.unet import UNet, UNetConfig


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _flatten(sub, f"{prefix}.{key}" if prefix else str(key))


def _load(module: torch.nn.Module, params, conv_hwio: bool):
    """Copy the JAX pytree ``params`` into ``module`` by path, cast to the
    module's dtypes; 4-D leaves are conv kernels (HWIO -> OIHW) when
    ``conv_hwio``. Raises ValueError if the paths or shapes differ."""
    own = module.state_dict()
    flat = dict(_flatten(params))
    if flat.keys() != own.keys():
        raise ValueError(
            f"parameter trees differ: missing {sorted(own.keys() - flat.keys())}, "
            f"unexpected {sorted(flat.keys() - own.keys())}")
    state = {}
    for name, leaf in flat.items():
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if conv_hwio and t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        if t.shape != own[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(own[name].shape)}")
        state[name] = t.to(dtype=own[name].dtype)
    module.load_state_dict(state, strict=True)
    return module


def unet_from_jax(params, cfg: UNetConfig, device="cuda") -> UNet:
    """A :class:`UNet` on ``device`` (the card by default) holding the weights of the JAX pytree
    ``params`` (nested dicts/lists of numpy arrays, e.g. bf16 from ml_dtypes),
    cast to the port's parameter dtypes. Raises ValueError if the trees'
    paths or shapes differ."""
    return _load(UNet(cfg, device=device), params, conv_hwio=True)


def transformer_from_jax(params, cfg: TransformerConfig, device="cuda") -> Transformer:
    """A :class:`Transformer` on ``device`` (the card by default) holding the weights of the JAX
    pytree ``params`` (``{"embed", "ln_f", "layers": [...]}`` of numpy
    arrays), cast to ``cfg.dtype``. Every leaf keeps its shape. Raises
    ValueError if the trees' paths or shapes differ."""
    return _load(Transformer(cfg, device=device), params, conv_hwio=False)


def mhdpa_from_flax(params, *, num_heads: int, causal: bool = False, window=None,
                    impl: str = "auto", dtype: torch.dtype = torch.float32,
                    device="cuda") -> FlashMultiHeadDotProductAttention:
    """A :class:`FlashMultiHeadDotProductAttention` on ``device`` (the card by
    default) holding the weights of a flax ``MultiHeadDotProductAttention``:
    ``params`` is its variables (``{"params": {...}}``) or their
    ``"params"`` tree, numpy leaves ``query``/``key``/``value``/``out``
    ``kernel`` and ``bias``, cast to ``dtype``. The widths come from the
    kernels' shapes. Raises ValueError if the trees differ."""
    params = params.get("params", params)
    in_features, _, head_dim = np.shape(params["query"]["kernel"])
    module = FlashMultiHeadDotProductAttention(
        num_heads, in_features, qkv_features=num_heads * head_dim,
        out_features=np.shape(params["out"]["kernel"])[-1], use_bias="bias" in params["query"],
        causal=causal, window=window, impl=impl, dtype=dtype, device=device)
    return _load(module, params, conv_hwio=False)


def _tensor_from_numpy(x, device) -> torch.Tensor:
    """A numpy leaf as a torch tensor of the same dtype, bit for bit: bf16 by
    way of f32 (exact), fp8 e4m3 (which numpy lacks; ml_dtypes gives it) as
    its bytes reinterpreted."""
    x = np.asarray(x)
    if str(x.dtype) == "float8_e4m3fn":
        t = torch.from_numpy(x.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    elif str(x.dtype) == "bfloat16":
        t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(x.copy())
    return t.to(device)


def kv_cache_from_jax(cache, device="cuda") -> dict:
    """The port's KV cache (``models.transformer.init_kv_cache``'s dict) from
    a JAX one, its leaves as numpy arrays -- bf16, f32, int8 or fp8 payloads
    and f32 scales -- on ``device`` (the card by default), every value kept
    bit for bit;
    ``length`` becomes a Python int."""
    out = {"length": int(np.asarray(cache["length"]))}
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in cache:
            out[name] = [_tensor_from_numpy(x, device) for x in cache[name]]
    return out
