"""The port's distribution layer against the JAX package's on the 8-device
virtual CPU mesh.

``make_mesh``, ``head_parallel_attention`` and
``ulysses_attention(_sharded)`` of the port run on a ``VirtualMesh`` of CPU
ranks (``ring_attention`` is held in tests/test_torch_ring.py); the JAX
functions run under ``shard_map`` on the virtual devices of
``tests/conftest.py`` (Pallas in interpret mode). Inputs and the
output cotangent are drawn in f32 with numpy from a seed and handed to both;
outputs within FWD_TOL[f32] and gradients (autograd against ``jax.grad`` of
the same global function) within BWD_TOL[f32]. A gloo case spawns 4
processes, each one rank of a ``ProcessGroupMesh``, and holds the ring and
one sharded LM step against the ``VirtualMesh`` run in this process.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from flashattn_tpu_torch.parallel import (
    VirtualMesh,
    head_parallel_attention,
    make_mesh,
    ring_attention_sharded,
    ulysses_attention,
)
from flashattn_tpu_torch.parallel.ulysses import ulysses_attention_sharded
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

F32_FWD, F32_BWD = FWD_TOL[torch.float32], BWD_TOL[torch.float32]


def _jax_mesh(data=1, model=1, seq=1):
    import jax

    from flashattn_tpu.parallel import make_mesh as jax_make_mesh

    if jax.device_count() < data * model * seq:
        pytest.skip(f"needs {data * model * seq} devices (virtual CPU mesh)")
    return jax_make_mesh(data=data, model=model, seq=seq)


def _both(port_fn, jax_fn, tensors, extra=()):
    """Output and gradients of ``port_fn`` (autograd) and ``jax_fn``
    (jax.grad of <O, g>) on the same f32 inputs; ``tensors`` = (q, k, v, g),
    ``extra`` non-differentiable trailing arguments (numpy for JAX)."""
    import jax
    import jax.numpy as jnp

    q, k, v, g = tensors
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = port_fn(*leaves, *extra)
    got = (o.detach(), *torch.autograd.grad(o, leaves, g))
    jargs = [jnp.asarray(x.numpy()) for x in (q, k, v)]
    jextra = [jnp.asarray(np.asarray(e)) for e in extra]
    jg = jnp.asarray(g.numpy())
    jo = jax_fn(*jargs, *jextra)
    grads = jax.grad(lambda a, b, c: jnp.sum(jax_fn(a, b, c, *jextra) * jg),
                     argnums=(0, 1, 2))(*jargs)
    return got, (np.asarray(jo), *(np.asarray(x) for x in grads))


def _assert_same(got, want):
    assert_close(got[0], want[0], F32_FWD, "O")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert_close(a, b, F32_BWD, name)


def _inputs(seed, B, Hq, N, D, Hkv=None):
    q, k, v = make_qkv(seed, B, Hq, N, D, Hkv=Hkv)
    return q, k, v, make_qkv(seed + 1, B, Hq, N, D)[0]


def _packed(seed, B, N, docs=3):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, N), docs - 1, replace=False))
    row = np.zeros(N, np.int32)
    for c in cuts:
        row[c:] += 1
    return torch.from_numpy(np.tile(row, (B, 1)))


# ---------------------------------------------------------------------------
# make_mesh


def test_make_mesh_shapes_and_names():
    mesh = make_mesh(data=2, model=2, seq=2, devices="cpu")
    assert isinstance(mesh, VirtualMesh)
    assert mesh.shape == {"data": 2, "model": 2, "seq": 2}
    assert mesh.axis_names == ("data", "model", "seq") and mesh.ranks == tuple(range(8))
    assert mesh.coords(5) == {"data": 1, "model": 0, "seq": 1}  # row-major, seq innermost
    sliced = make_mesh(data=1, model=2, seq=2, slices=2, devices="cpu")
    assert sliced.axis_names == ("slice", "data", "model", "seq") and sliced.size == 8
    assert make_mesh(seq=4, devices="cpu").shape == {"data": 1, "model": 1, "seq": 4}
    jmesh = _jax_mesh(2, 2, 2)
    assert dict(jmesh.shape) == mesh.shape


def test_make_mesh_too_many_ranks():
    """The JAX ValueError when the mesh needs more devices than it is given;
    a VirtualMesh counts ranks, not cards, and its ranks share one device."""
    with pytest.raises(ValueError, match="exceeds 4 devices"):
        make_mesh(data=2, model=2, seq=2, devices=["cpu"] * 4)
    assert make_mesh(data=2, model=2, seq=2, devices=["cpu"] * 8).size == 8
    with pytest.raises(ValueError, match="share one device"):
        make_mesh(seq=2, devices=["cpu", "meta"])


def test_virtual_collectives():
    """psum, all_gather, tiled all_to_all and ppermute over one axis of a
    (2, 2) mesh, as jax.lax's collectives compute them."""
    mesh = make_mesh(data=2, seq=2, devices="cpu")
    xs = [torch.arange(4.0).reshape(1, 4) + 10 * r for r in mesh.ranks]
    assert [x.tolist() for x in mesh.psum(xs, "seq")] == (
        [[[10.0, 12.0, 14.0, 16.0]]] * 2 + [[[50.0, 52.0, 54.0, 56.0]]] * 2)
    assert mesh.psum(xs, ("data", "seq"))[3].tolist() == [[60.0, 64.0, 68.0, 72.0]]
    assert mesh.all_gather(xs, "seq", dim=1)[1].tolist() == [[0, 1, 2, 3, 10, 11, 12, 13]]
    a2a = mesh.all_to_all(xs, "seq", split_dim=1, concat_dim=0)
    assert a2a[0].tolist() == [[0, 1], [10, 11]] and a2a[1].tolist() == [[2, 3], [12, 13]]
    shifted = mesh.ppermute(xs, "seq", [(1, 0)])
    assert shifted[0].tolist() == xs[1].tolist() and shifted[1].eq(0).all()
    assert mesh.axis_index("seq") == [0, 1, 0, 1] and mesh.axis_index("data") == [0, 0, 1, 1]


# ---------------------------------------------------------------------------
# head-parallel


@pytest.mark.parametrize("shape,hkv,causal", [((2, 4, 1), 8, True), ((1, 4, 1), 2, False)],
                         ids=["data x model causal", "GQA KV replicated"])
def test_head_parallel_matches_jax(shape, hkv, causal):
    from flashattn_tpu.parallel import head_parallel_attention as jax_head_parallel

    data, model, seq = shape
    batch_axis = "data" if data > 1 else None
    tensors = _inputs(3 + hkv, 2, 8, 128, 32, Hkv=hkv)
    got, want = _both(
        head_parallel_attention(make_mesh(data, model, seq, devices="cpu"), causal=causal,
                                batch_axis=batch_axis),
        jax_head_parallel(_jax_mesh(data, model, seq), causal=causal, batch_axis=batch_axis),
        tensors)
    _assert_same(got, want)


# ---------------------------------------------------------------------------
# Ulysses


@pytest.mark.parametrize("opts", [dict(causal=True), dict(causal=True, window=(50, -1)),
                                  dict(causal=True, ids=True), dict(hkv=2)],
                         ids=["causal", "window", "segment ids", "GQA repeated"])
def test_ulysses_matches_jax(opts):
    from flashattn_tpu.parallel.ulysses import ulysses_attention_sharded as jax_ulysses

    kw = dict(opts)
    ids = kw.pop("ids", False)
    hkv = kw.pop("hkv", None)
    tensors = _inputs(11, 2, 4, 256, 32, Hkv=hkv)
    extra = (_packed(12, 2, 256),) if ids else ()
    got, want = _both(
        ulysses_attention_sharded(make_mesh(data=2, seq=4, devices="cpu"),
                                  with_segment_ids=ids, **kw),
        jax_ulysses(_jax_mesh(data=2, seq=4), with_segment_ids=ids, **kw),
        tensors, extra)
    _assert_same(got, want)


def test_ulysses_rejections():
    """The JAX ValueErrors: a bias, and heads not divisible by the axis."""
    mesh = make_mesh(seq=4, devices="cpu")
    q, k, v, _ = _inputs(13, 1, 4, 256, 32)
    shards = [mesh.shard(x, (None, None, "seq", None)) for x in (q, k, v)]
    with pytest.raises(ValueError, match="does not support bias"):
        ulysses_attention(*shards, mesh=mesh, bias=torch.zeros(1, 1, 64, 64))
    q6 = make_qkv(14, 1, 6, 256, 32)[0]
    with pytest.raises(ValueError, match="n_devices | heads"):
        ulysses_attention(mesh.shard(q6, (None, None, "seq", None)), *shards[1:], mesh=mesh)


# ---------------------------------------------------------------------------
# The gloo case: a ProcessGroupMesh of 4 processes against the VirtualMesh.

GLOO_DEADLINE_S = 120
GLOO_SHAPE = dict(data=1, model=2, seq=2)


def _gloo_problem(mesh):
    """The ring's output and gradients on (data 1, model 2, seq 2) and one
    sharded LM step's loss and updated parameters, on ``mesh``'s ranks."""
    from flashattn_tpu_torch.models.transformer import (
        TransformerConfig, adamw_init, init_transformer, make_sharded_train_step, shard_params)

    q, k, v, g = _inputs(40, 1, 4, 256, 32, Hkv=2)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ring_attention_sharded(mesh, causal=True)(*leaves)
    grads = torch.autograd.grad(o, leaves, g)
    cfg = TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_head=32, d_ff=128, dtype=torch.float32)
    model = init_transformer(cfg, torch.Generator().manual_seed(41), device="cpu")
    tokens = torch.randint(0, 128, (2, 64), generator=torch.Generator().manual_seed(42))
    step, _, _ = make_sharded_train_step(mesh, cfg, lr=1e-3)
    params = shard_params(model, mesh)
    _, _, loss = step(params, [adamw_init(p) for p in params], tokens)
    return o.detach(), grads, float(loss), params


def _gloo_worker(rank: int, world: int, store_path: str, results) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store_path}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        o, grads, loss, params = _gloo_problem(make_mesh(**GLOO_SHAPE))
        results.put((rank, o.numpy(), [x.numpy() for x in grads], loss,
                     {n: t.numpy() for n, t in params[0].items()}))
    finally:
        dist.destroy_process_group()


def test_gloo_process_group_mesh_matches_virtual_mesh(tmp_path):
    """4 processes, each one rank of a ProcessGroupMesh over gloo (DeviceMesh
    subgroups per axis; K/V and the dK/dV accumulators sent by the ring's
    ProcessGroupRing; psum / all_gather / ppermute through the mesh's
    differentiable collectives): every rank's ring output, its block of the
    ring's gradients, the step's loss and its updated parameter shards equal
    the VirtualMesh's. Joined against a deadline, so a hung rendezvous fails
    the test instead of stalling the suite."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    world = 4
    procs = [ctx.Process(target=_gloo_worker, args=(r, world, str(tmp_path / "store"), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, *rest = results.get(timeout=GLOO_DEADLINE_S)
            got[rank] = rest
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    mesh = make_mesh(**GLOO_SHAPE, devices="cpu")
    o, grads, loss, params = _gloo_problem(mesh)
    spec = ("data", "model", "seq", None)
    for r in range(world):
        o_r, grads_r, loss_r, params_r = got[r]
        assert_close(torch.from_numpy(o_r), o, F32_FWD, "O")
        for name, a, b in zip(("dq", "dk", "dv"), grads_r, grads):
            assert_close(mesh.shard(torch.from_numpy(a), spec)[r], mesh.shard(b, spec)[r],
                         F32_BWD, name)
        assert abs(loss_r - loss) < 1e-5
        for n, t in params_r.items():
            assert_close(torch.from_numpy(t), params[r][n], F32_FWD, n)
