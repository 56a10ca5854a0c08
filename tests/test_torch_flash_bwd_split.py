"""The port's two-kernel backward (K5 ``dkv``, K6 ``dq``: wrappers and plain
versions) and the backward routing of flash_attention, on CPU.

On a CPU tensor ``flash_bwd.dkv``/``flash_bwd.dq`` run their plain versions,
which are held here against torch autograd through the f32 oracle (the port
of the JAX oracle; tests/test_torch_segments.py holds the whole gradient
against ``jax.grad`` of the JAX package). Budget: BWD_TOL[f32] (1e-3 abs +
5e-4 rel, the f32 kernel budget). The routing follows the JAX
``_flash_core_bwd``: the single-pass K3 without segment ids, K5 then K6 with
them.
"""

import numpy as np
import pytest
import torch

import flashattn_tpu_torch
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd, oracle
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, Tolerance, assert_close, make_qkv


def _ids(seed, B, N, max_segs=4):
    bounds = np.random.default_rng(seed).random((B, N)) < max_segs / N
    return torch.from_numpy(np.cumsum(bounds, axis=1).astype(np.int32))


def _case(kind, B=2, Nq=130, Nk=130):
    """Segment ids: random contiguous documents, (q_ids, kv_ids) with
    Nq != Nk, or the dead rows of tests/test_segments.py (query rows of a
    segment no key carries)."""
    if kind == "random":
        ids = _ids(1, B, Nq)
        return Nq, Nq, (ids, ids)
    if kind == "tuple":
        return Nq, Nk + 40, (_ids(2, B, Nq), _ids(3, B, Nk + 40))
    seg_q = torch.zeros(B, Nq, dtype=torch.int32)
    seg_q[:, Nq // 2:] = 7
    return Nq, Nq, (seg_q, torch.zeros(B, Nq, dtype=torch.int32))


def _fwd_and_oracle_grads(kind, causal, scale=0.3):
    B, Hq, Hkv, D = 2, 4, 2, 40
    Nq, Nk, seg = _case(kind, B)
    q, k, v = make_qkv(31, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(32, B, Hq, Nq, D)[0]
    o, lse = flash_fwd.fwd_reference(q, k, v, scale=scale, causal=causal, segment_ids=seg)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    want = torch.autograd.grad(oracle.attention_reference(
        qg, kg, vg, scale=scale, causal=causal, segment_ids=seg), (qg, kg, vg), do)
    args = (q, k, v, do, lse, (do * o).sum(-1))
    return args, dict(scale=scale, causal=causal, segment_ids=seg), want


@pytest.mark.parametrize("kind", ["random", "tuple", "dead"])
@pytest.mark.parametrize("causal", [False, True])
def test_dkv_dq_references_match_oracle_autograd(causal, kind):
    """dK/dV come per query head (GQA 4/2) and sum to the oracle's per KV head."""
    args, kw, want = _fwd_and_oracle_grads(kind, causal)
    q, k = args[0], args[1]
    B, Hq, Nq, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    dk, dv = flash_bwd.dkv_reference(*args, **kw)
    dq = flash_bwd.dq_reference(*args, **kw)
    assert dq.shape == q.shape and dk.shape == dv.shape == (B, Hq, Nk, D)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    tol = BWD_TOL[torch.float32]
    assert_close(dq, want[0], tol, "dq")
    assert_close(dk.view(B, Hkv, Hq // Hkv, Nk, D).sum(2), want[1], tol, "dk")
    assert_close(dv.view(B, Hkv, Hq // Hkv, Nk, D).sum(2), want[2], tol, "dv")


@pytest.mark.parametrize("causal", [False, True])
def test_dkv_dq_equal_k3_without_segments(causal):
    """Without segments the two passes compute what the single-pass K3 does."""
    q, k, v = make_qkv(41, 1, 4, 96, 32, Nk=120, Hkv=2)
    do = make_qkv(42, 1, 4, 96, 32)[0]
    o, lse = flash_fwd.fwd_reference(q, k, v, scale=0.2, kv_valid_len=100, causal=causal)
    args = (q, k, v, do, lse, (do * o).sum(-1))
    kw = dict(scale=0.2, causal=causal, kv_valid_len=100)
    dq3, dk3, dv3 = flash_bwd_fused.bwd(*args, **kw)
    dk, dv = flash_bwd.dkv(*args, **kw)
    assert torch.equal(flash_bwd.dq(*args, **kw), dq3)
    assert torch.equal(dk, dk3) and torch.equal(dv, dv3)
    assert not dk[:, :, 100:].any() and not dv[:, :, 100:].any()


def test_dead_rows_give_zero_dq_and_nothing_to_dkv():
    """A dead row's dO cannot reach dK/dV, and its dQ is exactly 0: P = 0
    explicitly for masked pairs, whatever the dead row's LSE (ln2 * mask)."""
    args, kw, _ = _fwd_and_oracle_grads("dead", causal=False)
    q, k, v, do, lse, delta = args
    dead = ~flash_fwd.pair_mask(q.shape[2], k.shape[2], kv_valid_len=k.shape[2], causal=False,
                                segment_ids=kw["segment_ids"], device="cpu").any(-1)
    dead = dead.expand(lse.shape)
    assert dead.any() and torch.all(lse[dead] == np.log(2.0) * oracle.DEFAULT_MASK_VALUE)
    dq = flash_bwd.dq(*args, **kw)
    assert not dq[dead].any()
    do2 = do.clone()
    do2[dead] = 1e3
    delta2 = delta.clone()
    delta2[dead] = -5.0
    dk, dv = flash_bwd.dkv(*args, **kw)
    dk2, dv2 = flash_bwd.dkv(q, k, v, do2, lse, delta2, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("segmented", [False, True])
def test_backward_routes_like_jax(monkeypatch, segmented):
    """With segment ids the backward runs the JAX package's two-kernel
    branch, K5 + K6 (here in one launch, ``split_bwd``), and not K3 or the
    separate K5 / K6; without them K3 only."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(flash_bwd_fused, "bwd", spy("K3", flash_bwd_fused.bwd))
    monkeypatch.setattr(flash_bwd, "split_bwd", spy("K5 + K6", flash_bwd.split_bwd))
    monkeypatch.setattr(flash_bwd, "dkv", spy("K5", flash_bwd.dkv))
    monkeypatch.setattr(flash_bwd, "dq", spy("K6", flash_bwd.dq))
    q, k, v = make_qkv(51, 1, 4, 64, 32, Hkv=2)
    q.requires_grad_(True)
    seg = _ids(52, 1, 64) if segmented else None
    o = flashattn_tpu_torch.flash_attention(q, k, v, causal=True, segment_ids=seg)
    assert calls == []
    o.sum().backward()
    assert calls == (["K5 + K6"] if segmented else ["K3"])


@pytest.mark.parametrize("fn", ["dkv", "dq"])
def test_split_bwd_takes_no_plain_path_off_the_cpu(fn):
    """Only a CPU tensor runs the plain version: a tensor on another device
    (here the meta device) gets no silent fallback."""
    q = torch.empty(1, 2, 64, 40, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        getattr(flash_bwd, fn)(q, q, q, q, lse, lse, scale=0.1)


def test_split_bwd_launch_counters_do_not_move_on_cpu(monkeypatch):
    """K5 and K6 have no kernel of their own: on CPU tensors they run their
    plain versions and never reach the kernel library."""
    def no_library():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(native, "kernels", no_library)
    args, kw, _ = _fwd_and_oracle_grads("random", causal=True)
    flash_bwd.dkv(*args, **kw)
    flash_bwd.dq(*args, **kw)


@pytest.mark.parametrize("fn", ["dkv", "dq"])
def test_split_bwd_validation_errors(fn):
    q, k, v = make_qkv(61, 2, 4, 32, 16, Hkv=2)
    lse = torch.zeros(2, 4, 32)
    call = getattr(flash_bwd, fn)
    ids = torch.zeros(2, 32, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_valid_len"):
        call(q, k, v, q, lse, lse, scale=0.1, kv_valid_len=33)
    with pytest.raises(ValueError, match="lse"):
        call(q, k, v, q, lse[:, :, :8], lse, scale=0.1)
    with pytest.raises(ValueError, match="segment ids"):
        call(q, k, v, q, lse, lse, scale=0.1, segment_ids=(ids, ids[:, :16]))
    with pytest.raises(ValueError, match="integers"):
        call(q, k, v, q, lse, lse, scale=0.1, segment_ids=(ids.float(), ids))


def test_recompute_p_ds_rows_sum_to_one():
    """P = exp(S·scale − LSE) with the forward's LSE is the softmax: each live
    row sums to 1, each dead row is all zeros."""
    args, kw, _ = _fwd_and_oracle_grads("tuple", causal=False)
    p, ds, *_ = flash_bwd.recompute_p_ds(*args, **kw)
    rows = p.sum(-1)
    live = rows > 0
    assert (~live).any()
    assert_close(rows[live], torch.ones_like(rows[live]), Tolerance(1e-5, 0.0), "row sums")
    assert not ds[~live].any()
