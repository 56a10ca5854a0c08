"""The ring kernels' f32 and D 136-256 forms (K7 / K8 in csrc/ring_fwd.cu,
csrc/ring_bwd.cu, csrc/flash_fwd_f32.cu, csrc/flash_bwd_f32.cu) as the host
glue in parallel/ring_kernel.py drives them, checked on CPU where no kernel
runs:

* the plain ring at Gemma 2's heads of 256 and at the f32 LM's attention
  width (Hq / Hkv as there, narrow chunks) against the JAX ring kernel in
  interpret mode on the virtual CPU mesh, forward and ``jax.grad`` (the
  cases that are the same test as tests/test_torch_ring_kernel.py's and
  tests/test_torch_ring_kernel_bwd.py's are parametrised there);
* the two f32 C entries' argument packing (``_launch_fwd`` /
  ``_launch_bwd`` with pieces) through a stand-in library with
  ``native.RING_{FWD,BWD}_F32_ARGTYPES``, as ctypes converts them;
* the routes on a simulated card (meta tensors, the launch replaced by that
  stand-in): the C entry by dtype, the head dim each form receives (D 100
  padded to 104, D 136-256 on the bf16 entry), the pieces' scratch sizes,
  q (and dO) split once per rank and per ring, the launch counters, and the
  refusals left -- D above 256 naming "'also open: options'", fp16 at the
  kernel level, a q_pieces buffer of the wrong size.

Inputs are drawn with numpy from a seed (utils.testing.make_qkv) and handed
to both frameworks; budgets FWD_TOL / BWD_TOL of the inputs' dtype.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from flashattn_tpu_torch.ops import f32_split
from flashattn_tpu_torch.ops.flash_fwd import kernel_window
from flashattn_tpu_torch.parallel import ring_attention_kernel_sharded
from flashattn_tpu_torch.parallel import ring_kernel as rk
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

NQ = 128  # rows per chunk


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh

    from flashattn_tpu.utils import platform

    if jax.device_count() < n:
        pytest.skip(f"needs {n} devices (virtual CPU mesh)")
    platform.patch_io_callback_inline()
    return Mesh(np.array(jax.devices()[:n]), axis_names=("seq",))


# (ranks, Hq, Hkv, D, dtype, causal, window): Gemma 2's GQA 8/4 at D 256 in
# bf16, causal and windowed, and the f32 LM's 16/8 at D 128 (f32 at D 256,
# 136 and 100 are cases of tests/test_torch_ring_kernel.py's and
# tests/test_torch_ring_kernel_bwd.py's tests).
MODEL_CASES = [
    (2, 8, 4, 256, torch.bfloat16, True, None),
    (2, 8, 4, 256, torch.bfloat16, True, (160, -1)),
    (2, 16, 8, 128, torch.float32, True, None),
]


def _model_inputs(ranks, hq, hkv, d, dtype):
    seed = 500 + ranks + hq + d
    q, k, v = make_qkv(seed, 1, hq, ranks * NQ, d, Hkv=hkv)
    do = make_qkv(seed + 1, 1, hq, ranks * NQ, d)[0]
    return tuple(x.to(dtype) for x in (q, k, v, do))


@pytest.mark.parametrize("ranks,hq,hkv,d,dtype,causal,window", MODEL_CASES)
def test_plain_ring_matches_jax_at_model_widths(ranks, hq, hkv, d, dtype, causal, window):
    """The port's ring on the CPU (the steps' plain versions) against the JAX
    ring kernel (interpret mode): O against ``ring_attention_kernel_sharded``
    and dQ / dK / dV against ``jax.grad`` of ``ring_attention_kernel`` in
    ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import PartitionSpec

    from flashattn_tpu.parallel.ring_kernel import ring_attention_kernel
    from flashattn_tpu.parallel.ring_kernel import ring_attention_kernel_sharded as jax_ring

    mesh = _jax_mesh(ranks)
    q, k, v, do = _model_inputs(ranks, hq, hkv, d, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    to_jax = lambda x: jnp.asarray(x.float().numpy()).astype(jdt)  # noqa: E731
    fn = jax_ring(mesh, axis="seq", batch_axis=None, head_axis=None, causal=causal,
                  window=window, interpret_params=pltpu.InterpretParams())
    want_o = np.asarray(fn(*(to_jax(x) for x in (q, k, v))).astype(jnp.float32))

    def loss(a, b, c, g):
        o = ring_attention_kernel(a, b, c, axis_name="seq", axis_size=ranks, causal=causal,
                                  window=window)
        return jnp.sum(o.astype(jnp.float32) * g.astype(jnp.float32))

    spec = PartitionSpec(None, None, "seq", None)
    want = jax.jit(jax.shard_map(
        jax.grad(loss, argnums=(0, 1, 2)), mesh=mesh, in_specs=(spec,) * 4,
        out_specs=(spec,) * 3, check_vma=False,
    ))(*(to_jax(x) for x in (q, k, v, do)))
    leaves = tuple(x.clone().requires_grad_(True) for x in (q, k, v))
    o = ring_attention_kernel_sharded(ranks=ranks, causal=causal, window=window)(*leaves)
    got = torch.autograd.grad(o, leaves, do)
    assert o.dtype == dtype and all(g.dtype == dtype for g in got)
    assert_close(o.float(), want_o, FWD_TOL[dtype], "O")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g.float(), np.asarray(w.astype(jnp.float32)), BWD_TOL[dtype], name)


# ---------------------------------------------------------------------------
# The f32 C entries' arguments.

B, HQ, HKV, N = 2, 4, 2, 512  # global [B, H, N, D]; chunks of N / 2 rows
C = N // 2


def _stand_in():
    """A stand-in for the kernel library: ctypes functions with the four ring
    C entries' argument types, recording what each receives."""
    seen = []
    fns = {name: ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(
        lambda *args, name=name: seen.append((name, args)) or 0)
        for name, argtypes in (("fa_ring_fwd_bf16", native.RING_FWD_ARGTYPES),
                               ("fa_ring_bwd_bf16", native.RING_BWD_ARGTYPES),
                               ("fa_ring_fwd_f32", native.RING_FWD_F32_ARGTYPES),
                               ("fa_ring_bwd_f32", native.RING_BWD_F32_ARGTYPES))}
    return types.SimpleNamespace(**fns), seen


def _chunks(d, dtype=torch.float32, device="cpu"):
    """Rank 1's query and K/V chunks, views of global BNHD tensors, and the
    f32 state."""
    kw = dict(dtype=dtype, device=device)
    glob = lambda h: torch.zeros(B, N, h, d, **kw).transpose(1, 2)  # noqa: E731
    q2, o, do = (glob(HQ).narrow(2, C, C) for _ in range(3))
    k, v = (glob(HKV).narrow(2, C, C) for _ in range(2))
    f32 = dict(dtype=torch.float32, device=device)
    acc = torch.zeros(B, HQ, C, d, **f32)
    st = [torch.zeros(B, HQ, C, **f32) for _ in range(4)]
    return q2, k, v, o, do, acc, st


def _pieces(d, q_operands):
    box = f32_split.d_box(d)
    q_p = torch.zeros(q_operands * 3 * B * HQ * C * box, dtype=torch.bfloat16)
    kv_p = torch.zeros(2 * 3 * B * HKV * C * box, dtype=torch.bfloat16)
    return q_p, kv_p


@pytest.mark.parametrize("d,split_q", [(128, True), (256, False), (136, True)])
def test_f32_fwd_launch_packs_the_c_arguments(d, split_q):
    q2, k, v, o, _, acc, (m, l, lse, _) = _chunks(d)
    q_p, kv_p = _pieces(d, 1)
    lib, seen = _stand_in()
    rc = rk._launch_fwd(lib, q2, k, v, acc, m, l, o, lse, q_base=C, kv_off=0, causal=True,
                        window=(100, -1), first=False, last=True, stream=4096,
                        pieces=(q_p, kv_p, split_q))
    assert rc == 0 and len(seen) == 1 and seen[0][0] == "fa_ring_fwd_f32"
    args = seen[0][1]
    assert len(args) == len(native.RING_FWD_F32_ARGTYPES) == 34
    assert args[:8] == tuple(x.data_ptr() for x in (q2, k, v, acc, m, l, o, lse))
    assert args[8:11] == (q_p.data_ptr(), kv_p.data_ptr(), int(split_q))
    assert args[11:17] == (B, HQ, HKV, C, C, d)
    assert args[17:19] == (C, 0)
    assert args[19:22] == (1, *kernel_window((100, -1)))
    assert args[22:24] == (0, 1)
    assert args[24:27] == (N * HQ * d, d, HQ * d)
    assert args[27:30] == (N * HKV * d, d, HKV * d)
    assert args[30:33] == args[24:27]
    assert args[33] == 4096


@pytest.mark.parametrize("d,split_q", [(128, False), (256, True)])
def test_f32_bwd_launch_packs_the_c_arguments(d, split_q):
    q2, k, v, _, do, dq, (lse, delta, _, _) = _chunks(d)
    dk, dv = (torch.zeros(B, HKV, C, d) for _ in range(2))
    q_p, kv_p = _pieces(d, 2)
    lib, seen = _stand_in()
    rc = rk._launch_bwd(lib, q2, k, v, do, lse, delta, dq, dk, dv, q_base=C, kv_off=C,
                        causal=False, window=(-1, 50), stream=8192, pieces=(q_p, kv_p, split_q))
    assert rc == 0 and len(seen) == 1 and seen[0][0] == "fa_ring_bwd_f32"
    args = seen[0][1]
    assert len(args) == len(native.RING_BWD_F32_ARGTYPES) == 33
    assert args[:9] == tuple(x.data_ptr() for x in (q2, k, v, do, lse, delta, dq, dk, dv))
    assert args[9:12] == (q_p.data_ptr(), kv_p.data_ptr(), int(split_q))
    assert args[12:18] == (B, HQ, HKV, C, C, d)
    assert args[18:20] == (C, C)
    assert args[20:23] == (0, *kernel_window((-1, 50)))
    assert args[23:26] == (N * HQ * d, d, HQ * d)
    assert args[26:29] == (N * HKV * d, d, HKV * d)
    assert args[29:32] == args[23:26]
    assert args[32] == 8192


# ---------------------------------------------------------------------------
# The routes on a simulated card.


@pytest.fixture
def card(monkeypatch):
    """The wrappers' path on meta tensors with the stand-in library in place
    of the built one and the kernels' dtype and head-dim checks kept (a meta
    tensor passes them as a CUDA one of its shape and dtype would): returns
    what the library received."""
    lib, seen = _stand_in()
    check = rk._check_kernel_args
    monkeypatch.setattr(rk, "_check_kernel_args", lambda q, name: check(types.SimpleNamespace(
        shape=q.shape, dtype=q.dtype, device=torch.device("cuda")), name))
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    for step in (rk.ring_fwd_step, rk.ring_bwd_step):
        for key in ("launches", "launches_f32", "launches_d256", "launches_split"):
            monkeypatch.setattr(step, key, 0)
    return seen


def _counts():
    return {f"{name} {key}": getattr(step, key)
            for name, step in (("K7", rk.ring_fwd_step), ("K8", rk.ring_bwd_step))
            for key in ("launches", "launches_f32", "launches_d256", "launches_split")}


# (dtype, D, the C entries, the head dim they receive, ranks, causal, window).
ROUTE_CASES = [
    (torch.bfloat16, 64, "bf16", 64, 2, True, None),
    (torch.bfloat16, 256, "bf16", 256, 4, True, None),
    (torch.bfloat16, 136, "bf16", 136, 2, True, (127, -1)),
    (torch.float32, 128, "f32", 128, 4, True, (300, -1)),
    (torch.float32, 256, "f32", 256, 2, False, None),
    (torch.float32, 100, "f32", 104, 2, False, None),
    (torch.float16, 200, "bf16", 200, 2, True, None),
]


@pytest.mark.parametrize("dtype,d,entry,d_kernel,ranks,causal,window", ROUTE_CASES)
def test_ring_routes_every_dtype_and_head_dim_to_the_kernels(card, dtype, d, entry, d_kernel,
                                                              ranks, causal, window):
    """``ring_attention_kernel_sharded`` forward and backward on a simulated
    card: every K7 / K8 launch reaches the C entry of the (dispatched) dtype
    with the head dim padded to a multiple of 8, one launch per live (rank,
    step); each f32 launch splits k and v, and q (dO) only on the rank's
    first live step; the counters count each form; O and the gradients come
    back at the caller's D and dtype."""
    n = ranks * 128
    q = torch.empty(1, 8, n, d, dtype=dtype, device="meta", requires_grad=True)
    k, v = (torch.empty(1, 2, n, d, dtype=dtype, device="meta", requires_grad=True)
            for _ in range(2))
    o = ring_attention_kernel_sharded(ranks=ranks, causal=causal, window=window)(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert o.shape == q.shape and o.dtype == dtype
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    live = [rk._live_steps(r, ranks, 128, 128, causal, rk.check_window(window))
            for r in range(ranks)]
    n_live = sum(map(len, live))
    fwd = [args for name, args in card if name.startswith("fa_ring_fwd")]
    bwd = [args for name, args in card if name.startswith("fa_ring_bwd")]
    assert {name for name, _ in card} == {f"fa_ring_fwd_{entry}", f"fa_ring_bwd_{entry}"}
    assert len(fwd) == len(bwd) == n_live
    f32, wide = entry == "f32", d_kernel > 128
    dims = 11 if f32 else 8  # the index of B in the argument list
    assert all(a[dims:dims + 6] == (1, 8, 2, 128, 128, d_kernel) for a in fwd)
    assert all(a[dims + 1:dims + 7] == (1, 8, 2, 128, 128, d_kernel) for a in bwd)
    if f32:
        # The rank's q (dO) is split once a ring: split_q on its first live step only.
        q_base = [a[dims + 6] // 128 for a in fwd]
        want = [s == steps[0] for steps in live for s in range(ranks) if s in steps]
        got = {}
        for r, a in zip(q_base, fwd):
            got.setdefault(r, []).append(a[10])
        assert [x for r in sorted(got) for x in got[r]] == [int(w) for w in want]
        assert sum(a[11] for a in bwd) == ranks  # K8: split_q once a rank
    want_counts = {"launches": n_live, "launches_f32": n_live * f32,
                   "launches_d256": n_live * wide, "launches_split": n_live * f32}
    assert _counts() == {f"{s} {k}": v for s in ("K7", "K8") for k, v in want_counts.items()}


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float32, 264, "'also open: options'"),
    (torch.bfloat16, 512, "'also open: options'"),
    (torch.float32, 100, "multiples of 8"),
    (torch.float16, 64, "takes bfloat16 and float32"),
])
def test_steps_refuse_what_no_form_takes(card, dtype, d, match):
    """The steps on the card raise NotImplementedError, before any launch,
    for a head dim above 256 (the entry points pad the others), one that is
    not a multiple of 8 at the kernel level, and a dtype other than bf16 /
    f32 (the entry points cast fp16 to bf16)."""
    q2, k, v, o, do, acc, (m, l, lse, delta) = _chunks(d, dtype, "meta")
    with pytest.raises(NotImplementedError, match=match):
        rk.ring_fwd_step(q2, k, v, acc, m, l, o, lse, q_base=C, kv_off=0, first=True)
    dk, dv = (torch.zeros(B, HKV, C, d, device="meta") for _ in range(2))
    with pytest.raises(NotImplementedError, match=match):
        rk.ring_bwd_step(q2, k, v, do, lse, delta, acc, dk, dv, q_base=C, kv_off=0)
    assert card == []


def test_entry_points_refuse_above_256_on_the_card(card):
    """A head dim above 256 raises from the entry point, naming the queue."""
    x = torch.empty(1, 2, 256, 264, device="meta")
    with pytest.raises(NotImplementedError, match="'also open: options'"):
        ring_attention_kernel_sharded(ranks=2)(x, x, x)
    assert card == []


@pytest.mark.parametrize("d,operands", [(128, 1), (256, 2), (136, 1), (64, 2)])
def test_f32_steps_size_their_pieces(card, d, operands):
    """An f32 step without q_pieces makes and splits its own (split_q 1); a
    given q_pieces of [operands, 3, B, Hq, nq, d_box] bf16 elements is passed
    as it is with the caller's split_q; another size raises ValueError
    before any launch. The K/V pieces are [2, 3, B, Hkv, nk, d_box]."""
    q2, k, v, o, do, acc, (m, l, lse, delta) = _chunks(d, torch.float32, "meta")
    dk, dv = (torch.zeros(B, HKV, C, d, device="meta") for _ in range(2))
    box = f32_split.d_box(d)
    n_q = operands * 3 * B * HQ * C * box
    assert rk.q_pieces_scratch(q2, operands).shape == (n_q,)

    def step(**kw):
        if operands == 1:
            rk.ring_fwd_step(q2, k, v, acc, m, l, o, lse, q_base=C, kv_off=0, first=True, **kw)
        else:
            rk.ring_bwd_step(q2, k, v, do, lse, delta, acc, dk, dv, q_base=C, kv_off=0, **kw)

    step()
    given = torch.empty(n_q, dtype=torch.bfloat16, device="meta")
    step(q_pieces=given, split_q=False)
    (_, a1), (_, a2) = card
    at = 8 if operands == 1 else 9  # q_pieces' place in the argument list
    assert a1[at + 2] == 1 and a2[at + 2] == 0
    with pytest.raises(ValueError, match="q_pieces"):
        step(q_pieces=torch.empty(n_q - 8, dtype=torch.bfloat16, device="meta"))
    assert len(card) == 2
    assert rk._f32_pieces(q2, k, given, False, operands)[1].numel() == 2 * 3 * B * HKV * C * box


def test_f32_step_tensors_must_share_q2s_dtype(card):
    """The f32 forms read k, v, o and dO in f32: a bf16 one beside an f32 q2
    raises ValueError before any launch."""
    q2, k, v, o, _, acc, (m, l, lse, _) = _chunks(128, torch.float32, "meta")
    with pytest.raises(ValueError, match="torch.bfloat16"):
        rk.ring_fwd_step(q2, k.bfloat16(), v.bfloat16(), acc, m, l, o, lse, q_base=C,
                         kv_off=0, first=True)
    with pytest.raises(ValueError, match="o torch.bfloat16"):
        rk.ring_fwd_step(q2, k, v, acc, m, l, o.bfloat16(), lse, q_base=C, kv_off=0,
                         first=True)
    assert card == []


def test_pad_d_pads_to_a_multiple_of_8_and_the_ring_slices_back():
    """The entry points' padding: zero columns up to a multiple of 8; on the
    CPU, D 100 through the padded ring equals the unpadded plain steps."""
    x = torch.randn(1, 2, 4, 100)
    (p,) = rk._pad_d(x)
    assert p.shape[-1] == 104 and p[..., 100:].eq(0).all() and p[..., :100].equal(x)
    assert rk._pad_d(p)[0] is p
    q, k, v = make_qkv(71, 1, 4, 256, 100, Hkv=2)
    do = make_qkv(72, 1, 4, 256, 100)[0]
    got = rk.run_virtual_ring(q, k, v, do, ranks=2, causal=True)
    xport = rk.VirtualRanks(2)
    scale = 100 ** -0.5
    q2 = rk._prescale(q, scale)
    o = torch.empty_like(q)
    lses = rk._ring_forward(xport, xport.split(q2), xport.split(k), xport.split(v),
                            xport.split(o), causal=True, window=None)
    grads = rk._ring_grads(xport, q2, k, v, o, lses, do, scale=scale, causal=True, window=None)
    assert got[0].shape == q.shape
    assert_close(got[0], o, FWD_TOL[torch.float32], "O")
    assert_close(got[1], xport.join(lses), FWD_TOL[torch.float32], "LSE")
    for name, g, w in zip(("dq", "dk", "dv"), got[2:], grads):
        assert_close(g, w, BWD_TOL[torch.float32], name)
