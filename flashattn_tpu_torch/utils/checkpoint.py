"""Checkpoint / resume for model + optimizer state (port of flashattn_tpu/utils/checkpoint.py).

The JAX module writes pytrees with orbax (or a numpy ``.npz``); here a state
is a nested structure of dicts, lists and tuples whose leaves are tensors and
Python scalars, written with ``torch.save`` and read back with
``torch.load(weights_only=True)``, which unpickles nothing but such data.

    from flashattn_tpu_torch.utils import checkpoint as ckpt
    ckpt.save(path, {"params": params, "opt": opt, "step": 100})
    state = ckpt.restore(path)                # or restore(path, like=state0)

``restore(like=)`` keeps the JAX module's checks -- a ``ValueError`` when the
checkpoint's structure or a leaf's shape differs from ``like``'s -- and gives
each tensor ``like``'s dtype and device.
"""

from __future__ import annotations

import os

import torch


def _leaves(tree, path=()):
    """``(path, leaf)`` of every leaf of ``tree``, dict keys in sorted order
    (as ``jax.tree_util`` flattens a dict)."""
    if isinstance(tree, dict):
        for key in sorted(tree, key=repr):
            yield from _leaves(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, path + (i,))
    else:
        yield path, tree


def _map(fn, tree, path=()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {key: _map(fn, x, path + (key,)) for key, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x, path + (i,)) for i, x in enumerate(tree))
    return fn(path, tree)


def save(path: str, state, *, force: bool = True) -> str:
    """Write ``state`` (nested dicts / lists / tuples of tensors and scalars)
    to the file ``path``; with ``force`` False an existing file raises
    ``FileExistsError``. The file is written under a private name and then
    renamed, so a reader never sees half of it. Returns the absolute path."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = _map(lambda _, x: x.detach() if isinstance(x, torch.Tensor) else x, state)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def restore(path: str, *, like=None):
    """Read a checkpoint written by :func:`save`. Without ``like`` the state
    comes back as it was saved (tensors on the devices they were saved
    from). With ``like``, a state of the same structure: ``ValueError`` when
    the checkpoint's leaves are not ``like``'s (their number or their place
    in the structure) or a saved tensor's shape is not its ``like`` leaf's;
    each tensor comes back in its ``like`` leaf's dtype and on its device,
    each scalar as saved."""
    path = os.path.abspath(path)
    saved = torch.load(path, map_location=None if like is None else "cpu", weights_only=True)
    if like is None:
        return saved
    got = dict(_leaves(saved))
    want = [p for p, _ in _leaves(like)]
    if len(got) != len(want) or set(got) != set(want):
        raise ValueError(f"checkpoint {path} holds {len(got)} leaves but `like` has "
                         f"{len(want)} -- structure mismatch")
    index = {p: i for i, p in enumerate(want)}

    def leaf(p, ref):
        x = got[p]
        if isinstance(ref, torch.Tensor):
            shape = tuple(x.shape) if isinstance(x, torch.Tensor) else ()
            if shape != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {index[p]} {p}: saved shape {shape} != "
                                 f"`like` shape {tuple(ref.shape)}")
            return torch.as_tensor(x).to(dtype=ref.dtype, device=ref.device)
        return x

    return _map(leaf, like)


def latest_step_dir(root: str) -> str | None:
    """Return the highest-numbered subdirectory of ``root`` (step layout
    ``root/<step>/``), or None. Convention for resumable training loops."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=int))
