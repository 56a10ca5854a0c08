"""The port's ring attention (parallel/ring.py, parallel/ring_kernel.py) on CPU:
the forward against the JAX ring kernel, the ring algebra and one step of K7
and K8's plain versions against the JAX package, and the torch.distributed
transport across two gloo processes.

On CPU tensors the port runs the plain versions of K7 and K8 over the same
rotation as on the card; the JAX package runs its Pallas ring kernel in
interpret mode on the 8-device virtual mesh, as tests/test_ring_kernel.py
does. Inputs are drawn in f32 with numpy from a seed and handed to both;
budgets are FWD_TOL[f32] for outputs and BWD_TOL[f32] for gradients (the
package's f32 kernel budgets). JAX is imported inside the tests that compare
with it: the gloo test's worker lives in this module, and the processes it
spawns import it.
"""

import datetime
import math

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from flashattn_tpu_torch.ops.flash import flash_attention
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE, attention_reference_with_lse
from flashattn_tpu_torch.parallel import ring, ring_attention_kernel, ring_attention_kernel_sharded
from flashattn_tpu_torch.parallel import ring_kernel as rk
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

H, NQ = 2, 128  # heads, local chunk rows


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh

    from flashattn_tpu.utils import platform

    if jax.device_count() < n:
        pytest.skip(f"needs {n} devices (virtual CPU mesh)")
    platform.patch_io_callback_inline()
    return Mesh(np.array(jax.devices()[:n]), axis_names=("seq",))


def _grads(fn, q, k, v, do):
    leaves = tuple(x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = fn(*leaves)
    return (o.detach(), *torch.autograd.grad(o, leaves, do))


# (ranks, causal, window, Hkv, D): the JAX ring kernel tests' masks, both
# windows, GQA with one KV head, at 2 and 4 ranks; head dims above 128 (D
# 256, D 136 with a window and GQA) and one the entry point pads (D 100).
FWD_CASES = [
    (4, True, None, 2, 128),
    (4, False, None, 2, 64),
    (4, True, (160, -1), 2, 128),
    (4, False, (160, 160), 2, 64),
    (4, True, None, 1, 64),
    (2, True, None, 2, 64),
    (2, False, (160, 160), 1, 128),
    (2, True, None, 1, 256),
    (4, True, (160, -1), 1, 136),
    (2, False, None, 2, 100),
]


@pytest.mark.parametrize("ranks,causal,window,hkv,d", FWD_CASES)
def test_ring_forward_matches_jax_ring_kernel(ranks, causal, window, hkv, d):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from flashattn_tpu.parallel.ring_kernel import ring_attention_kernel_sharded as jax_ring

    mesh = _jax_mesh(ranks)
    q, k, v = make_qkv(ranks * 10 + d + hkv, 1, H, ranks * NQ, d, Hkv=hkv)
    fn = jax_ring(mesh, axis="seq", batch_axis=None, head_axis=None, causal=causal,
                  window=window, interpret_params=pltpu.InterpretParams())
    want = np.asarray(fn(*(jnp.asarray(x.numpy()) for x in (q, k, v))))
    got = ring_attention_kernel_sharded(ranks=ranks, causal=causal, window=window)(q, k, v)
    assert_close(got, want, FWD_TOL[torch.float32])


# (causal, window, Hkv): the per-step algebra, every rank of a 4-rank ring.
STEP_CASES = [(True, None, 2), (False, None, 1), (True, (160, -1), 2)]


def _jax_window_bias(window, q_off, kv_off):
    """The window as an additive mask (0 / mask value) for the JAX oracle
    with the LSE, which takes causal offsets but no window."""
    import jax.numpy as jnp

    qp = jnp.arange(NQ)[:, None] + q_off
    kp = jnp.arange(NQ)[None, :] + kv_off
    keep = jnp.ones((NQ, NQ), bool)
    if window is not None:
        wl, wr = window
        if wl >= 0:
            keep &= kp >= qp - wl
        if wr >= 0:
            keep &= kp <= qp + wr
    return jnp.where(keep, 0.0, DEFAULT_MASK_VALUE)[None, None]


@pytest.mark.parametrize("causal,window,hkv", STEP_CASES)
def test_fwd_step_reference_matches_jax_merge_after_each_step(causal, window, hkv):
    """K7's plain version, step by step: the running state, normalised
    (O = acc / l, LSE = (m + log2 l) ln2), after each live step equals the
    JAX ring's LSE merge (ring.py `_merge`) of the JAX oracle's per-chunk
    partials at the same global offsets; the port's `_merge` over the port's
    oracle gives the same."""
    import jax.numpy as jnp

    from flashattn_tpu.ops.oracle import attention_reference_with_lse as jax_ref
    from flashattn_tpu.parallel import ring as jax_ring

    P, d = 4, 64
    scale = d ** -0.5
    q, k, v = make_qkv(11 + hkv, 1, H, P * NQ, d, Hkv=hkv)
    q2 = rk._prescale(q, scale)
    chunk = lambda x, r: x[:, :, r * NQ:(r + 1) * NQ]  # noqa: E731
    for r in range(P):
        steps = rk._live_steps(r, P, NQ, NQ, causal, window)
        acc, m, l = torch.empty(1, H, NQ, d), torch.empty(1, H, NQ), torch.empty(1, H, NQ)
        o_fin, lse_fin = torch.empty(1, H, NQ, d), torch.empty(1, H, NQ)
        o_j, lse_j = jnp.zeros((1, H, NQ, d)), jnp.full((1, H, NQ), -jnp.inf)
        o_t, lse_t = torch.zeros(1, H, NQ, d), torch.full((1, H, NQ), -math.inf)
        for s in steps:
            src = (r - s) % P
            rk.ring_fwd_step_reference(
                chunk(q2, r), chunk(k, src), chunk(v, src), acc, m, l, o_fin, lse_fin,
                q_base=r * NQ, kv_off=src * NQ, causal=causal, window=window,
                first=s == steps[0], last=s == steps[-1])
            qj, kj, vj = (jnp.asarray(chunk(x, i).numpy()) for x, i in ((q, r), (k, src), (v, src)))
            o_p, lse_p = jax_ref(qj, kj, vj, causal=causal, scale=scale, q_offset=r * NQ,
                                 kv_offset=src * NQ, bias=_jax_window_bias(window, r * NQ, src * NQ))
            o_j, lse_j = jax_ring._merge(o_j, lse_j, o_p, lse_p)
            kf = torch.repeat_interleave(chunk(k, src), H // hkv, 1)
            vf = torch.repeat_interleave(chunk(v, src), H // hkv, 1)
            bias = torch.from_numpy(np.array(_jax_window_bias(window, r * NQ, src * NQ)))
            o_p2, lse_p2 = attention_reference_with_lse(
                chunk(q, r), kf, vf, causal=causal, scale=scale, q_offset=r * NQ,
                kv_offset=src * NQ, bias=bias)
            o_t, lse_t = ring._merge(o_t, lse_t, o_p2, lse_p2)
            if s == steps[-1]:
                o_s, lse_s = o_fin, lse_fin
            else:
                o_s, lse_s = acc / l[..., None], (m + torch.log2(l)) * rk.LN2
            assert_close(o_s, np.asarray(o_j), FWD_TOL[torch.float32], f"O rank {r} step {s}")
            assert_close(lse_s, np.asarray(lse_j), FWD_TOL[torch.float32], f"LSE rank {r} step {s}")
            assert_close(o_t, np.asarray(o_j), FWD_TOL[torch.float32], "port _merge O")
            assert_close(lse_t, np.asarray(lse_j), FWD_TOL[torch.float32], "port _merge LSE")


@pytest.mark.parametrize("causal,window,hkv", STEP_CASES)
def test_bwd_step_reference_matches_jax_chunk_grads(causal, window, hkv):
    """K8's plain version, one (rank, step) at a time: dQ·scale, dK·ln2 and
    dV from one chunk pair equal the per-chunk gradients written over the
    JAX oracle -- P = exp(S·scale − L) with the GLOBAL LSE, dS = P (dP − Δ)
    (ring.py:66-128, `_chunk_grads`) -- and summed over the ring they equal
    jax.grad of the oracle on the whole sequence."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.ops.oracle import attention_reference as jax_oracle

    P, d = 4, 64
    N, scale, rep = P * NQ, d ** -0.5, H // hkv
    q, k, v = make_qkv(21 + hkv, 1, H, N, d, Hkv=hkv)
    do = make_qkv(22, 1, H, N, d)[0]
    qj, kj, vj, doj = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    kr, vr = jnp.repeat(kj, rep, axis=1), jnp.repeat(vj, rep, axis=1)
    o_full = jax_oracle(qj, kr, vr, causal=causal, window=window)
    s_full = jnp.einsum("bhqd,bhkd->bhqk", qj, kr, precision="highest") * scale
    keep = jnp.asarray(rk.position_mask(N, N, causal=causal, window=window).numpy())
    s_full = jnp.where(keep, s_full, DEFAULT_MASK_VALUE)
    lse = jax.scipy.special.logsumexp(s_full, axis=-1)
    delta = jnp.sum(doj * o_full, axis=-1)
    grad_want = jax.grad(lambda a, b, c: jnp.sum(jax_oracle(a, b, c, causal=causal,
                                                            window=window) * doj),
                         (0, 1, 2))(qj, kj, vj)
    q2 = rk._prescale(q, scale)
    lse_t, delta_t = torch.from_numpy(np.array(lse)), torch.from_numpy(np.array(delta))
    total = [torch.zeros_like(x) for x in (q, k, v)]
    rows = lambda x, r: x[:, :, r * NQ:(r + 1) * NQ]  # noqa: E731
    for r in range(P):
        for s in rk._live_steps(r, P, NQ, NQ, causal, window):
            src = (r - s) % P
            dq, dk, dv = (torch.zeros(1, x.shape[1], NQ, d) for x in (q, k, v))
            rk.ring_bwd_step_reference(rows(q2, r), rows(k, src), rows(v, src), rows(do, r),
                                       rows(lse_t, r).contiguous(), rows(delta_t, r).contiguous(),
                                       dq, dk, dv, q_base=r * NQ, kv_off=src * NQ,
                                       causal=causal, window=window)
            qs, dos = rows(qj, r), rows(doj, r)
            ks, vs = rows(kr, src), rows(vr, src)
            p = jnp.where(keep[:, :, r * NQ:(r + 1) * NQ, src * NQ:(src + 1) * NQ],
                          jnp.exp(rows(s_full, r)[..., src * NQ:(src + 1) * NQ]
                                  - rows(lse, r)[..., None]), 0.0)
            ds = p * (jnp.einsum("bhqd,bhkd->bhqk", dos, vs, precision="highest")
                      - rows(delta, r)[..., None])
            dq_w = jnp.einsum("bhqk,bhkd->bhqd", ds, ks, precision="highest") * scale
            dk_w = jnp.einsum("bhqk,bhqd->bhkd", ds, qs, precision="highest") * scale
            dv_w = jnp.einsum("bhqk,bhqd->bhkd", p, dos, precision="highest")
            dk_w, dv_w = (x.reshape(1, hkv, rep, NQ, d).sum(2) for x in (dk_w, dv_w))
            tol = BWD_TOL[torch.float32]
            assert_close(dq * scale, np.asarray(dq_w), tol, f"dQ rank {r} step {s}")
            assert_close(dk * rk.LN2, np.asarray(dk_w), tol, f"dK rank {r} step {s}")
            assert_close(dv, np.asarray(dv_w), tol, f"dV rank {r} step {s}")
            total[0][:, :, r * NQ:(r + 1) * NQ] += dq * scale
            total[1][:, :, src * NQ:(src + 1) * NQ] += dk * rk.LN2
            total[2][:, :, src * NQ:(src + 1) * NQ] += dv
    for name, got, want in zip(("dq", "dk", "dv"), total, grad_want):
        assert_close(got, np.asarray(want), BWD_TOL[torch.float32], f"ring sum {name}")


def test_perm_and_merge_match_jax():
    """The rotation's pairs and the LSE merge of two normalised partials,
    dead rows (LSE −inf on one side) included."""
    import jax.numpy as jnp

    from flashattn_tpu.parallel import ring as jax_ring

    assert all(ring._perm(n) == jax_ring._perm(n) for n in (1, 2, 4, 8))
    rng = np.random.default_rng(5)
    o1, o2 = (rng.standard_normal((1, 2, 8, 16), dtype=np.float32) for _ in range(2))
    l1, l2 = (rng.standard_normal((1, 2, 8), dtype=np.float32) * 4 for _ in range(2))
    l1[0, 0, :3] = -np.inf
    got = ring._merge(*(torch.from_numpy(x) for x in (o1, l1, o2, l2)))
    want = jax_ring._merge(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w), FWD_TOL[torch.float32])


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, (160, -1)),
                                           (False, (-1, 50)), (False, (160, 160)),
                                           (True, (0, 0))])
def test_chunk_needed_matches_jax(causal, window):
    """The whole-chunk skip, as a Python bool, over a grid of chunk offsets."""
    from flashattn_tpu.parallel import ring as jax_ring

    for nq, nk in ((128, 128), (256, 128)):
        for q_off in range(0, 1024, 128):
            for kv_off in range(0, 1024, 128):
                got = ring._chunk_needed(q_off, kv_off, nq, nk, causal, window)
                want = bool(jax_ring._chunk_needed(q_off, kv_off, nq, nk, causal, window))
                assert got is want, (q_off, kv_off, nq, nk)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, (100, -1))])
def test_one_rank_equals_flash_attention(causal, window):
    """A ring of one: K7 both starts and finalizes, K8 runs once, and the
    result is the port's flash_attention (K1, K3), forward and gradients."""
    q, k, v = make_qkv(31, 2, 4, 256, 64, Hkv=2)
    do = make_qkv(32, 2, 4, 256, 64)[0]
    got = _grads(ring_attention_kernel_sharded(ranks=1, causal=causal, window=window), q, k, v, do)
    want = _grads(lambda a, b, c: flash_attention(a, b, c, causal=causal, window=window),
                  q, k, v, do)
    assert_close(got[0], want[0], FWD_TOL[torch.float32], "O")
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert_close(g, w, BWD_TOL[torch.float32], name)
    # Outside a process group the local entry point is a ring of one as well.
    assert_close(ring_attention_kernel(q, k, v, causal=causal, window=window), want[0],
                 FWD_TOL[torch.float32], "O, ring_attention_kernel")


@pytest.mark.parametrize("call,match", [
    (lambda x: ring_attention_kernel(x(1, 1, 100, 64), x(1, 1, 100, 64), x(1, 1, 100, 64)),
     "128-aligned"),
    (lambda x: ring_attention_kernel_sharded(ranks=2)(x(1, 2, 200, 64), x(1, 2, 200, 64),
                                                      x(1, 2, 200, 64)), "128-aligned"),
    (lambda x: ring_attention_kernel(x(1, 3, 128, 64), x(1, 2, 128, 64), x(1, 2, 128, 64)),
     "must be a multiple of Hkv"),
    (lambda x: ring_attention_kernel_sharded(ranks=3)(x(1, 2, 512, 64), x(1, 2, 512, 64),
                                                      x(1, 2, 512, 64)), "do not split"),
])
def test_rejects_unsupported_chunks(call, match):
    """The JAX contract: local chunks of multiples of 128 rows (the JAX
    message), Hkv dividing Hq; and a global sequence that splits evenly."""
    with pytest.raises(ValueError, match=match):
        call(torch.zeros)


def test_steps_on_other_devices_launch_or_raise():
    """A wrapper takes its plain version only for CPU tensors; on any other
    device it launches its kernel or raises -- never a silent fallback."""
    x = torch.zeros((1, 2, 128, 64), device="meta")
    st = torch.zeros((1, 2, 128), device="meta")
    with pytest.raises(NotImplementedError, match="no K7 kernel"):
        rk.ring_fwd_step(x, x, x, x, st, st, x, st, q_base=0, kv_off=0, first=True, last=True)
    with pytest.raises(NotImplementedError, match="no K8 kernel"):
        rk.ring_bwd_step(x, x, x, x, st, st, x, x, x, q_base=0, kv_off=0)


def _step_tensors():
    bf = dict(dtype=torch.bfloat16)
    q2, k = torch.zeros(1, 4, 128, 64, **bf), torch.zeros(1, 2, 128, 64, **bf)
    return q2, k, k.clone(), torch.zeros(1, 4, 128, 64), torch.zeros(1, 4, 128)


@pytest.mark.parametrize("spoil,match", [
    (None, None),
    ("v_strides", "do not fit q2"),
    ("acc_layout", "must be contiguous f32"),
    ("o_misaligned", "16-byte loads"),
    ("o_dtype", "o torch.float32"),
])
def test_step_wrappers_check_what_the_kernel_addresses(spoil, match):
    """The checks K7's and K8's wrappers make before passing pointers: the
    kernels write in place and copy nothing, so a tensor they cannot address
    raises instead of being read or written past its layout."""
    q2, k, v, acc, st = _step_tensors()
    o = torch.zeros_like(q2)
    if spoil == "v_strides":
        v = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16).transpose(1, 2)
    elif spoil == "acc_layout":
        acc = torch.zeros(1, 4, 64, 128).transpose(2, 3)
    elif spoil == "o_misaligned":
        o = torch.zeros(1, 4, 128, 65, dtype=torch.bfloat16)[..., 1:]
    elif spoil == "o_dtype":
        o = o.float()
    f32 = {"acc": (acc, (1, 4, 128, 64)), "m": (st, (1, 4, 128)), "lse": (st, (1, 4, 128))}
    if match is None:
        rk._check_step_args("K7", q2, k, v, {"o": o}, f32)
    else:
        with pytest.raises(ValueError, match=match):
            rk._check_step_args("K7", q2, k, v, {"o": o}, f32)


def test_virtual_rotation_moves_each_chunk_right():
    """One rotation: rank i's tensors land in rank i + 1's slot (mod P)."""
    xport = rk.VirtualRanks(4)
    srcs = [(torch.full((2,), float(i)), torch.full((3,), 10.0 + i)) for i in range(4)]
    dsts = [(torch.empty(2), torch.empty(3)) for _ in range(4)]
    xport.wait(xport.rotate(srcs, dsts))
    for i in range(4):
        assert dsts[(i + 1) % 4][0].eq(i).all() and dsts[(i + 1) % 4][1].eq(10 + i).all()
    assert rk.ProcessGroupRing().world == 1  # no process group: a ring of one


# The gloo case: 2 processes, each one rank of a ring over a real process
# group, against the virtual-rank ring in this process.
GLOO_SHAPE = dict(B=1, H=4, Hkv=2, N=2 * 256, D=64)
GLOO_DEADLINE_S = 120


def _gloo_worker(rank: int, world: int, store_path: str, results) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store_path}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        s = GLOO_SHAPE
        q, k, v = make_qkv(41, s["B"], s["H"], s["N"], s["D"], Hkv=s["Hkv"])
        do = make_qkv(42, s["B"], s["H"], s["N"], s["D"])[0]
        n = s["N"] // world
        local = [x[:, :, rank * n:(rank + 1) * n].contiguous() for x in (q, k, v, do)]
        out = _grads(lambda a, b, c: ring_attention_kernel(a, b, c, causal=True,
                                                           window=(300, -1)),
                     *local)
        results.put((rank, [x.numpy() for x in out]))
    finally:
        dist.destroy_process_group()


def test_gloo_two_processes_match_virtual_ranks(tmp_path):
    """ring_attention_kernel over a 2-process gloo group (K/V and the dK/dV
    accumulators sent with dist.batch_isend_irecv) gives what the 2-rank
    virtual ring gives on the same inputs. The processes are joined against
    a deadline and killed past it, so a hung rendezvous fails this test
    instead of stalling the suite."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_gloo_worker, args=(r, 2, str(tmp_path / "store"), results))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, arrays = results.get(timeout=GLOO_DEADLINE_S)
            got[rank] = arrays
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    s = GLOO_SHAPE
    q, k, v = make_qkv(41, s["B"], s["H"], s["N"], s["D"], Hkv=s["Hkv"])
    do = make_qkv(42, s["B"], s["H"], s["N"], s["D"])[0]
    want = _grads(ring_attention_kernel_sharded(ranks=2, causal=True, window=(300, -1)),
                  q, k, v, do)
    for i, (name, w) in enumerate(zip(("o", "dq", "dk", "dv"), want)):
        joined = np.concatenate([got[0][i], got[1][i]], axis=2)
        tol = FWD_TOL[torch.float32] if name == "o" else BWD_TOL[torch.float32]
        assert_close(joined, w, tol, name)
