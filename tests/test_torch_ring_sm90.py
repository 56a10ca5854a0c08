"""The ring kernels K7 / K8 as the Hopper kernels take them
(csrc/ring_fwd.cu, csrc/ring_bwd.cu: 128-row tiles, TMA boxes of 64
columns), checked on CPU where no kernel runs:

* the plain ring (the steps' plain versions over the same rotation) against
  the JAX ring kernel, Pallas in interpret mode on the virtual CPU mesh, at
  chunks of 256 rows with the window's left edge at 127, 128, 129 and 255 --
  inside, on and past a 128-row tile's edge -- GQA rep 1 and 2, D 64 and 96
  (a head dim that fills one 64-column box and a half); the forward against
  ``ring_attention_kernel_sharded``, the gradients against ``jax.grad`` of
  ``ring_attention_kernel`` in ``shard_map`` (as
  tests/test_torch_ring_kernel_bwd.py runs it). Inputs are drawn in f32 with
  numpy from a seed and handed to both; budgets FWD_TOL[f32] and
  BWD_TOL[f32], the package's f32 kernel budgets;
* the packing of both C entries' arguments (``_launch_fwd`` /
  ``_launch_bwd``) through a stand-in library with the entries' argument
  types, as ctypes converts them for the real ``fa_ring_fwd_bf16`` /
  ``fa_ring_bwd_bf16``;
* the wrappers' checks of what a TMA map takes, on meta tensors with the
  launch itself replaced by that stand-in: a rank's chunk view of a global
  tensor is passed as it is, and a head-dim stride other than 1, a stride
  that is not a multiple of 8 elements, a zero stride on a dim of extent > 1
  or a base that is not 16-byte aligned raises ValueError before any
  launch.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from flashattn_tpu_torch.ops.flash_fwd import kernel_window
from flashattn_tpu_torch.parallel import ring_attention_kernel_sharded
from flashattn_tpu_torch.parallel import ring_kernel as rk
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

RANKS, H, NQ = 2, 2, 256  # ranks, query heads, rows per chunk

# (window, Hkv, D), causal: the left edge inside, on and past a tile's
# 128 rows and at the chunk's last row; rep 1 (Hkv 2) and 2 (Hkv 1).
EDGE_CASES = [((127, -1), 2, 64), ((128, -1), 1, 96), ((129, -1), 2, 96), ((255, -1), 1, 64)]


def _inputs(window, hkv, d):
    seed = 100 + window[0] + 7 * hkv + d
    q, k, v = make_qkv(seed, 1, H, RANKS * NQ, d, Hkv=hkv)
    do = make_qkv(seed + 1, 1, H, RANKS * NQ, d)[0]
    return q, k, v, do


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    from flashattn_tpu.utils import platform

    if jax.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} devices (virtual CPU mesh)")
    platform.patch_io_callback_inline()
    return Mesh(np.array(jax.devices()[:RANKS]), axis_names=("seq",))


@pytest.mark.parametrize("window,hkv,d", EDGE_CASES)
def test_plain_ring_forward_matches_jax_at_tile_edges(window, hkv, d):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from flashattn_tpu.parallel.ring_kernel import ring_attention_kernel_sharded as jax_ring

    mesh = _jax_mesh()
    q, k, v, _ = _inputs(window, hkv, d)
    fn = jax_ring(mesh, axis="seq", batch_axis=None, head_axis=None, causal=True, window=window,
                  interpret_params=pltpu.InterpretParams())
    want = np.asarray(fn(*(jnp.asarray(x.numpy()) for x in (q, k, v))))
    got = ring_attention_kernel_sharded(ranks=RANKS, causal=True, window=window)(q, k, v)
    assert_close(got, want, FWD_TOL[torch.float32], "O")


@pytest.mark.parametrize("window,hkv,d", EDGE_CASES)
def test_plain_ring_grads_match_jax_at_tile_edges(window, hkv, d):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from flashattn_tpu.parallel.ring_kernel import ring_attention_kernel

    mesh = _jax_mesh()
    q, k, v, do = _inputs(window, hkv, d)

    def loss(a, b, c, g):
        o = ring_attention_kernel(a, b, c, axis_name="seq", axis_size=RANKS, causal=True,
                                  window=window)
        return jnp.sum(o * g)

    spec = PartitionSpec(None, None, "seq", None)
    want = jax.jit(jax.shard_map(
        jax.grad(loss, argnums=(0, 1, 2)), mesh=mesh, in_specs=(spec,) * 4,
        out_specs=(spec,) * 3, check_vma=False,
    ))(*(jnp.asarray(x.numpy()) for x in (q, k, v, do)))
    leaves = tuple(x.clone().requires_grad_(True) for x in (q, k, v))
    o = ring_attention_kernel_sharded(ranks=RANKS, causal=True, window=window)(*leaves)
    got = torch.autograd.grad(o, leaves, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, np.asarray(w), BWD_TOL[torch.float32], name)


# ---------------------------------------------------------------------------
# The C entries' arguments.

B, HQ, HKV, N, D = 2, 4, 2, 512, 64  # global [B, H, N, D]; chunks of N / 2 rows
C = N // 2


def _stand_in():
    """A stand-in for the kernel library: ctypes functions with the C entries'
    argument types, recording what each receives (the real entries' order
    and conversions)."""
    seen = []
    fns = {name: ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(
        lambda *args, name=name: seen.append((name, args)) or 0)
        for name, argtypes in (("fa_ring_fwd_bf16", native.RING_FWD_ARGTYPES),
                               ("fa_ring_bwd_bf16", native.RING_BWD_ARGTYPES))}
    return types.SimpleNamespace(**fns), seen


def _chunks(device="cpu"):
    """Rank 1's query and K/V chunks (its diagonal step), views of global
    BNHD tensors (the models' layout) seen as [B, H, N, D]; the f32 state."""
    bf = dict(dtype=torch.bfloat16, device=device)
    glob = lambda h: torch.zeros(B, N, h, D, **bf).transpose(1, 2)  # noqa: E731
    q2, o, do = (glob(HQ).narrow(2, C, C) for _ in range(3))
    k, v = (glob(HKV).narrow(2, C, C) for _ in range(2))
    f32 = dict(dtype=torch.float32, device=device)
    acc = torch.zeros(B, HQ, C, D, **f32)
    st = [torch.zeros(B, HQ, C, **f32) for _ in range(4)]
    return q2, k, v, o, do, acc, st


# (first, last, causal, window): a first step with the state written, a last
# step reading it with a window, a lone step (no state) with a two-sided one.
FWD_PACK = [(True, False, True, None), (False, True, True, (100, -1)),
            (True, True, False, (64, 32))]


@pytest.mark.parametrize("first,last,causal,window", FWD_PACK)
def test_fwd_launch_packs_the_c_arguments(first, last, causal, window):
    q2, k, v, o, _, acc, (m, l, lse, _) = _chunks()
    if first and last:
        acc = m = l = None
    lib, seen = _stand_in()
    rc = rk._launch_fwd(lib, q2, k, v, acc, m, l, o, lse, q_base=C, kv_off=C, causal=causal,
                        window=window, first=first, last=last, stream=4096)
    assert rc == 0 and len(seen) == 1 and seen[0][0] == "fa_ring_fwd_bf16"
    args = seen[0][1]
    assert len(args) == len(native.RING_FWD_ARGTYPES) == 31
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    assert args[:8] == tuple(ptr(x) for x in (q2, k, v, acc, m, l, o, lse))
    assert args[0] == q2.data_ptr() != 0 and q2.data_ptr() % 16 == 0  # the view, not a copy
    assert args[8:14] == (B, HQ, HKV, C, C, D)
    assert args[14:16] == (C, C)
    assert args[16:19] == (int(causal), *kernel_window(window))
    assert args[19:21] == (int(first), int(last))
    assert args[21:24] == (N * HQ * D, D, HQ * D)  # BNHD: (batch, head, seq) strides
    assert args[24:27] == (N * HKV * D, D, HKV * D)
    assert args[27:30] == args[21:24]
    assert args[30] == 4096


# (causal, window) of a backward step.
BWD_PACK = [(True, None), (True, (127, -1)), (False, (-1, 50))]


@pytest.mark.parametrize("causal,window", BWD_PACK)
def test_bwd_launch_packs_the_c_arguments(causal, window):
    q2, k, v, _, do, dq, (lse, delta, _, _) = _chunks()
    dk, dv = (torch.zeros(B, HKV, C, D) for _ in range(2))
    lib, seen = _stand_in()
    rc = rk._launch_bwd(lib, q2, k, v, do, lse, delta, dq, dk, dv, q_base=C, kv_off=C,
                        causal=causal, window=window, stream=8192)
    assert rc == 0 and len(seen) == 1 and seen[0][0] == "fa_ring_bwd_bf16"
    args = seen[0][1]
    assert len(args) == len(native.RING_BWD_ARGTYPES) == 30
    assert args[:9] == tuple(x.data_ptr() for x in (q2, k, v, do, lse, delta, dq, dk, dv))
    assert args[9:15] == (B, HQ, HKV, C, C, D)
    assert args[15:17] == (C, C)
    assert args[17:20] == (int(causal), *kernel_window(window))
    assert args[20:23] == (N * HQ * D, D, HQ * D)
    assert args[23:26] == (N * HKV * D, D, HKV * D)
    assert args[26:29] == args[20:23]
    assert args[29] == 8192


# ---------------------------------------------------------------------------
# The wrappers' checks, up to the launch.


@pytest.fixture
def launches(monkeypatch):
    """The wrappers' path on meta tensors (which carry shapes, strides and
    offsets but no data) with the stand-in library in place of the built
    one: returns what it received."""
    lib, seen = _stand_in()
    monkeypatch.setattr(rk, "_check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return seen


def _spoil(kind, t):
    """Replace one tensor of ``t`` (name: tensor) by a layout TMA or the
    bulk copies cannot take."""
    meta = dict(device="meta")
    if kind == "q2 row stride 68":
        t["q2"] = torch.zeros(B, HQ, C, 68, dtype=torch.bfloat16, **meta)[..., :D]
    elif kind == "k expanded over heads":
        t["k"] = t["v"] = torch.zeros(B, 1, C, D, dtype=torch.bfloat16, **meta).expand(
            B, HKV, C, D)
    elif kind == "o base 8 bytes off":
        t["o"] = torch.zeros(B * HQ * C * D + 4, dtype=torch.bfloat16, **meta)[4:].view(
            B, HQ, C, D)
    elif kind == "lse base 4 bytes off":
        t["lse"] = torch.zeros(B * HQ * C + 1, **meta)[1:].view(B, HQ, C)
    elif kind == "do head-dim stride 2":
        t["do"] = torch.zeros(B, HQ, C, 2 * D, dtype=torch.bfloat16, **meta)[..., ::2]
    return t


@pytest.mark.parametrize("step,spoil", [
    ("fwd", None), ("bwd", None),
    ("fwd", "q2 row stride 68"), ("fwd", "k expanded over heads"),
    ("fwd", "o base 8 bytes off"), ("bwd", "lse base 4 bytes off"),
    ("bwd", "do head-dim stride 2"),
])
def test_wrappers_pass_chunk_views_and_refuse_what_tma_cannot_take(launches, step, spoil):
    q2, k, v, o, do, acc, (m, l, lse, delta) = _chunks("meta")
    t = _spoil(spoil, dict(q2=q2, k=k, v=v, o=o, do=do, lse=lse))
    before = (rk.ring_fwd_step.launches, rk.ring_bwd_step.launches)
    pos = dict(q_base=C, kv_off=C, causal=True, window=(127, -1))
    if step == "fwd":
        call = lambda: rk.ring_fwd_step(t["q2"], t["k"], t["v"], acc, m, l, t["o"],  # noqa: E731
                                        t["lse"], first=False, last=True, **pos)
    else:
        dk, dv = (torch.zeros(B, HKV, C, D, device="meta") for _ in range(2))
        call = lambda: rk.ring_bwd_step(t["q2"], t["k"], t["v"], t["do"], t["lse"],  # noqa: E731
                                        delta, acc, dk, dv, **pos)
    if spoil is None:
        call()
        (name, args), = launches
        assert name == f"fa_ring_{step}_bf16" and args[-1] == 77
        assert args[0] == t["q2"].data_ptr() and args[1] == k.data_ptr()  # views, not copies
        counts = (rk.ring_fwd_step.launches, rk.ring_bwd_step.launches)
        assert counts == (before[0] + (step == "fwd"), before[1] + (step == "bwd"))
    else:
        with pytest.raises(ValueError):
            call()
        assert launches == [] and (rk.ring_fwd_step.launches,
                                   rk.ring_bwd_step.launches) == before
