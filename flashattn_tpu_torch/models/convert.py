"""Carry U-Net weights from the JAX package's pytree to the port.

The JAX tree (``init_unet`` of flashattn_tpu/models/unet.py; leaves as numpy arrays)
and the port's :class:`UNet` have the same paths; only conv kernels change
layout, HWIO -> OIHW. With the weights carried over, both compute the same
function, which is how the tests hold the port to the JAX model.
"""

from __future__ import annotations

import numpy as np
import torch

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


def unet_from_jax(params, cfg: UNetConfig, device=None) -> UNet:
    """A :class:`UNet` on ``device`` holding the weights of the JAX pytree
    ``params`` (nested dicts/lists of numpy arrays, e.g. bf16 from ml_dtypes),
    cast to the port's parameter dtypes. Raises ValueError if the trees'
    paths or shapes differ."""
    unet = UNet(cfg, device=device)
    own = unet.state_dict()
    flat = dict(_flatten(params))
    if flat.keys() != own.keys():
        raise ValueError(
            f"parameter trees differ: missing {sorted(own.keys() - flat.keys())}, "
            f"unexpected {sorted(flat.keys() - own.keys())}")
    state = {}
    for name, leaf in flat.items():
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if t.ndim == 4:  # conv kernel: HWIO -> OIHW
            t = t.permute(3, 2, 0, 1)
        if t.shape != own[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(own[name].shape)}")
        state[name] = t.to(dtype=own[name].dtype)
    unet.load_state_dict(state, strict=True)
    return unet
