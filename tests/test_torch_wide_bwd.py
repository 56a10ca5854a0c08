"""The backward above head dim 128 -- K3's and the split route's D 256 form
(``csrc/bwd_sm90_wide.cuh``) -- against the JAX package on CPU.

The kernel runs only on the card (``python3 chip_smoke.py``:
``phase_wide_bwd_check`` holds it against the plain versions there,
``phase_wide_train`` trains the LM with heads of 256). Here:

* the plain versions at D 136 / 192 / 256 -- K3's ``bwd_reference``, the
  split route's ``split_bwd_reference``, K5's and K6's ``dkv_reference`` /
  ``dq_reference``, and the CPU backward of ``flash_attention`` that takes
  them -- against ``jax.vjp`` of the JAX ``flash_attention`` (its Pallas
  kernels in interpret mode) on the same numpy inputs, causal, with a
  window, segment ids, the cap, ids with the cap: budget BWD_TOL[f32];
* the routes on a simulated card (meta tensors, the device test off, the
  head-dim and dtype checks kept, a stand-in library recording each C
  entry): bf16 at D 136-256 reaches K3 or the split route and counts a D
  256 launch, with a bias the bias routes' D 256 forms; f32 at D 136
  reaches the f32 body's D 256 form (fa_bwd_f32), and D 264 raises naming
  its ROADMAP item, before any launch;
* the C arguments of a D 256 launch through stand-ins with the C entries'
  argtypes;
* the LM with 2 heads of 256 (d_model 512, 2 layers, 32 tokens) against the
  JAX ``lm_loss`` and ``jax.grad`` on weights carried by
  ``models/convert.py``, plain, capped and packed: loss within 1e-5, every
  gradient within BWD_TOL[f32].
"""

import contextlib
import ctypes
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu.models import transformer as jax_lm
from flashattn_tpu_torch.models import transformer as lm
from flashattn_tpu_torch.models.convert import _flatten, transformer_from_jax
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

F32 = torch.float32


def _ids(n, doc, batch=2):
    return torch.arange(n, dtype=torch.int32).repeat(batch, 1) // doc


# (D, Hq, Hkv, N, options): causal GQA, a window, packed ids, the cap, ids
# with the cap (and causal) -- D 136 and 192 run in the kernel's 256 box.
PLAIN_CASES = {
    "causal D 256": (256, 4, 2, 96, dict(causal=True)),
    "window D 192": (192, 2, 2, 80, dict(window=(16, 8))),
    "ids D 136": (136, 4, 2, 64, dict(segment_ids=30)),
    "softcap D 256": (256, 2, 1, 72, dict(logit_softcap=5.0)),
    "ids + softcap D 192": (192, 4, 2, 130, dict(causal=True, segment_ids=50,
                                                 logit_softcap=5.0)),
}


def _plain_kw(opts, n):
    kw = dict(opts)
    if "segment_ids" in kw:
        kw["segment_ids"] = _ids(n, kw["segment_ids"])
    return kw


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plain_versions_at_wide_head_dims_match_jax(case):
    """The gradients of the port's flash_attention on the CPU (its plain K1,
    then K3's or the split route's plain version) and of the plain K3 /
    split route / K5 + K6 called directly, against jax.vjp of the JAX
    flash_attention."""
    D, Hq, Hkv, N, opts = PLAIN_CASES[case]
    kw = _plain_kw(opts, N)
    q, k, v = make_qkv(D + N, 2, Hq, N, D, Hkv=Hkv)
    do = torch.from_numpy(np.random.default_rng(N).standard_normal(q.shape, dtype=np.float32))
    jkw = dict(kw)
    if "segment_ids" in jkw:
        jkw["segment_ids"] = jnp.asarray(jkw["segment_ids"].numpy())
    o_jax, vjp = jax.vjp(lambda a, b, c: flashattn_tpu.flash_attention(a, b, c, **jkw),
                         *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = flashattn_tpu_torch.flash_attention(*leaves, **kw)
    assert_close(o.detach(), np.asarray(o_jax), FWD_TOL[F32], "o")
    for name, g, w in zip(("dq", "dk", "dv"), torch.autograd.grad(o, leaves, do), want):
        assert_close(g, w, BWD_TOL[F32], f"flash_attention {name}")

    # The plain versions themselves, on the plain forward's LSE.
    scale = D ** -0.5
    fkw = dict(scale=scale, causal=kw.get("causal", False), window=kw.get("window"))
    if "segment_ids" in kw:
        fkw["segment_ids"] = (kw["segment_ids"], kw["segment_ids"])
    if "logit_softcap" in kw:
        fkw["softcap"] = kw["logit_softcap"]
    o32, lse = flash_fwd.fwd_reference(q, k, v, **fkw)
    delta = (do * o32).sum(-1)
    args = (q, k, v, do, lse, delta)
    if "segment_ids" in fkw or "softcap" in fkw:
        got = flash_bwd.split_bwd_reference(*args, **fkw)
    else:
        got = flash_bwd_fused.bwd_reference(*args, **fkw)
    dk5, dv5 = flash_bwd.dkv_reference(*args, **fkw)
    dq6 = flash_bwd.dq_reference(*args, **fkw)

    def per_kv_head(x):
        return x.view(2, Hkv, Hq // Hkv, N, D).sum(2)

    for name, g, w in zip(("dq", "dk", "dv"), (got[0], per_kv_head(got[1]),
                                               per_kv_head(got[2])), want):
        assert_close(g, w, BWD_TOL[F32], f"plain {name}")
    for name, g, w in zip(("K6 dq", "K5 dk", "K5 dv"), (dq6, per_kv_head(dk5),
                                                        per_kv_head(dv5)), want):
        assert_close(g, w, BWD_TOL[F32], name)


# ---------------------------------------------------------------------------
# The routes on a simulated card.


def _recorder(name, argtypes, seen):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: seen.append((name, args)) or 0)


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: the backward wrappers keep their
    head-dim and dtype checks (``flash_bwd.check_kernel_dims``) without the
    device test, K1's checks are off, and the stand-in library records the
    name and arguments of every C entry called."""
    calls = []
    typed = {"fa_fwd_sm90": native.FWD_SM90_ARGTYPES, "fa_bwd_sm90": native.BWD_SM90_ARGTYPES,
             "fa_bwd_split_sm90": native.BWD_SPLIT_SM90_ARGTYPES,
             "fa_fwd_bias_sm90": native.FWD_BIAS_SM90_ARGTYPES,
             "fa_bwd_bias_sm90": native.BWD_BIAS_SM90_ARGTYPES,
             "fa_fwd_f32": native.FWD_F32_ARGTYPES, "fa_bwd_f32": native.BWD_F32_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    lib.fa_fwd_quant_sm90 = lambda *args: calls.append(("fa_fwd_quant_sm90", args)) or 0
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    dims = flash_bwd.check_kernel_dims
    monkeypatch.setattr(flash_bwd, "check_kernel_args", dims)
    monkeypatch.setattr(flash_bwd_fused, "check_kernel_args", dims)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


def _meta_qkv(B, Hq, Hkv, Nq, Nk, D, dtype=torch.bfloat16):
    q = torch.empty((B, Nq, Hq, D), dtype=dtype, device="meta").transpose(1, 2)
    k, v = (torch.empty((B, Nk, Hkv, D), dtype=dtype, device="meta").transpose(1, 2)
            for _ in "kv")
    return q, k, v


BWD = {"K3": "fa_bwd_sm90", "split": "fa_bwd_split_sm90"}
# (D, N, options, the backward's route): bf16 above D 128 behind K1's dense
# route (fa_fwd_sm90, its D 256 form), on K3 or the split route, each a D 256
# launch.
ROUTES = {"causal D 256": (256, 300, dict(causal=True), "K3"),
          "window D 192": (192, 300, dict(causal=True, window=(100, -1)), "K3"),
          "softcap D 256": (256, 300, dict(causal=True, logit_softcap=50.0), "split"),
          "packed D 136": (136, 200, dict(causal=True, segment_ids=True), "split"),
          "ids + softcap D 160": (160, 200, dict(segment_ids=True, logit_softcap=5.0), "split")}


@pytest.mark.parametrize("case", list(ROUTES))
def test_bf16_wide_head_dims_reach_the_d256_form(card, case):
    D, N, opts, route = ROUTES[case]
    B, Hq, Hkv = 2, 8, 4
    q, k, v = (x.requires_grad_(True) for x in _meta_qkv(B, Hq, Hkv, N, N, D))
    kw = dict(opts)
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = torch.zeros((B, N), dtype=torch.int32, device="meta")
    counters = lambda: (flash_fwd.fwd.launches_dense_d256,  # noqa: E731
                        flash_bwd_fused.bwd.launches_d256, flash_bwd.split_bwd.launches_d256)
    before = counters()
    o = flashattn_tpu_torch.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert [name for name, _ in card] == ["fa_fwd_sm90", BWD[route]]
    assert card[0][1][13] == D  # the head dim the forward's C entry takes
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert counters() == (before[0] + 1, before[1] + (route == "K3"),
                          before[2] + (route == "split"))
    args = card[1][1]
    assert args[14 if route == "K3" else 18] == D  # the head dim the C entry takes
    assert args[21 if route == "K3" else 25] == -(-N // 64) * 64  # LSE / Δ rows padded to 64


def test_the_d128_calls_do_not_count_as_d256(card):
    q, k, v = (x.requires_grad_(True) for x in _meta_qkv(1, 4, 2, 128, 128, 128))
    before = flash_bwd_fused.bwd.launches_d256
    o = flashattn_tpu_torch.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert [name for name, _ in card] == ["fa_fwd_sm90", "fa_bwd_sm90"]
    assert flash_bwd_fused.bwd.launches_d256 == before


def test_a_bias_above_128_raises_naming_its_item(card):
    """A bias at D 136, which raised in the backward (naming functions item
    6) until the bias routes took D 136-256: it reaches K1's bias route's D
    256 form (fa_fwd_bias_sm90) and K5 + K6's (fa_bwd_bias_sm90), one launch
    each, each counted as a D 256 launch; dK / dV come back per KV head;
    nothing raises and nothing reaches the quantized route."""
    q, k, v = (x.requires_grad_(True) for x in _meta_qkv(1, 4, 2, 128, 128, 136))
    bias = torch.zeros((1, 1, 1, 128), device="meta")
    before = flash_fwd.fwd.launches_bias_d256, flash_bwd.bias_bwd.launches_d256
    o = flashattn_tpu_torch.flash_attention(q, k, v, bias=bias)
    grads = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert [name for name, _ in card] == ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert (flash_fwd.fwd.launches_bias_d256, flash_bwd.bias_bwd.launches_d256) == (
        before[0] + 1, before[1] + 1)
    assert card[0][1][14] == card[1][1][20] == 136  # the head dim each C entry takes
    stats = torch.empty((1, 4, 128), device="meta")
    dq, dk, dv, dbias = flash_bwd.bias_bwd(q, k, v, q, stats, stats, scale=0.1, bias=bias)
    assert dk.shape == dv.shape == (1, 2, 128, 136) and dbias is None
    assert [name for name, _ in card][2:] == ["fa_bwd_bias_sm90"]


@pytest.mark.parametrize("route", ["K3", "split"])
@pytest.mark.parametrize("dtype,D,item", [
    (F32, 136, None),
    (torch.bfloat16, 264, "K1 options: head dims above 256"),
    (F32, 264, "K1 options: head dims above 256")], ids=["f32 D 136", "bf16 D 264", "f32 D 264"])
def test_what_no_backward_takes_raises_naming_its_item(card, route, dtype, D, item):
    """D 264 raises naming its ROADMAP item, before any launch. f32 at D 136
    (``item`` None), which raised naming f32 rows item 5 until the f32 body's
    D 256 form, reaches ``fa_bwd_f32`` once, counted as a D 256 launch."""
    q, k, v = _meta_qkv(1, 4, 2, 128, 128, D, dtype=dtype)
    stats = torch.empty((1, 4, 128), device="meta")

    def backward():
        if route == "K3":
            return flash_bwd_fused.bwd(q, k, v, q, stats, stats, scale=0.1, causal=True)
        return flash_bwd.split_bwd(q, k, v, q, stats, stats, scale=0.1, softcap=5.0)

    if item is None:
        before = flash_bwd._f32_bwd_launch.launches_d256
        grads = backward()
        assert [name for name, _ in card] == ["fa_bwd_f32"]
        assert card[0][1][19] == D  # the head dim the C entry takes
        assert flash_bwd._f32_bwd_launch.launches_d256 == before + 1
        assert [g.shape for g in grads] == [q.shape, (1, 4, 128, D), (1, 4, 128, D)]
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 2, {item}"):
        backward()
    assert card == []


# ---------------------------------------------------------------------------
# The C arguments of a D 256 launch.


def _bnhd(*xs):
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2).to(torch.bfloat16) for x in xs)


def test_k3_d256_launch_packs_the_c_arguments():
    B, Hq, Hkv, Nq, Nk, D = 1, 4, 2, 70, 90, 256
    q, k, v = _bnhd(*make_qkv(31, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    do = q.clone()
    stats = torch.zeros((B, Hq, 128))
    dq = torch.zeros((B, Hq, Nq, D))
    dk, dv = torch.empty((B, Hq, Nk, D)), torch.empty((B, Hq, Nk, D))
    seen = []
    lib = types.SimpleNamespace(fa_bwd_sm90=_recorder("fa_bwd_sm90", native.BWD_SM90_ARGTYPES,
                                                      seen))
    rc = flash_bwd_fused._launch(lib, q, k, v, do, stats, stats, dq, dk, dv, scale=0.0625,
                                 causal=True, kv_valid_len=80, window=None, nq_pad=128,
                                 stream=4096, q_offset=64, kv_offset=32)
    assert rc == 0 and len(seen) == 1
    args = seen[0][1]
    assert len(args) == len(native.BWD_SM90_ARGTYPES)
    assert args[:9] == tuple(x.data_ptr() for x in (q, k, v, do, stats, stats, dq, dk, dv))
    assert args[9:19] == (B, Hq, Hkv, Nq, Nk, D, 80, 1, -1, -1)
    assert args[19:23] == (64, 32, 128, 0.0625)
    assert args[23:26] == (Nq * Hq * D, D, Hq * D)  # q: BNHD, (batch, head, seq)
    assert args[26:29] == (Nk * Hkv * D, D, Hkv * D)
    assert args[29:32] == args[26:29] and args[32:35] == args[23:26] and args[35] == 4096


def test_split_d256_launch_packs_the_c_arguments():
    """The D 256 form reads the wrapper's 64-row Q tile and 128-key tile id
    ranges, as the D <= 128 form does."""
    B, Hq, Hkv, Nq, Nk, D = 2, 2, 1, 96, 300, 192
    q, k, v = _bnhd(*make_qkv(32, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    do = q.clone()
    stats = torch.zeros((B, Hq, 128))
    dq = torch.zeros((B, Hq, Nq, D))
    dk, dv = torch.empty((B, Hq, Nk, D)), torch.empty((B, Hq, Nk, D))
    ids = (torch.arange(Nq).repeat(B, 1) // 40, torch.arange(Nk).repeat(B, 1) // 40)
    seg = flash_fwd.sm90_segments(ids, Nq, 290, q_tile=flash_bwd.SM90_BWD_Q_TILE,
                                  kv_tile=flash_bwd.SM90_BWD_KV_TILE, pad_q=True)
    seen = []
    lib = types.SimpleNamespace(fa_bwd_split_sm90=_recorder(
        "fa_bwd_split_sm90", native.BWD_SPLIT_SM90_ARGTYPES, seen))
    rc = flash_bwd._launch_split(lib, q, k, v, do, stats, stats, dq, dk, dv, seg, scale=0.0625,
                                 causal=False, kv_valid_len=290, window=(30, 5), softcap=50.0,
                                 nq_pad=128, stream=4096)
    assert rc == 0 and len(seen) == 1
    args = seen[0][1]
    assert args[9:13] == tuple(x.data_ptr() for x in seg)
    assert args[13:23] == (B, Hq, Hkv, Nq, Nk, D, 290, 0, 30, 5)
    assert args[23:28] == (0, 0, 128, 0.0625, 50.0)
    assert seg[0].shape == (B, 128) and seg[1].shape == (B, 384)  # rows of whole tiles


# ---------------------------------------------------------------------------
# The LM with heads of 256 against the JAX model.

WIDTH = dict(vocab_size=128, d_model=512, n_layers=2, n_heads=2, n_kv_heads=1, d_head=256,
             d_ff=256)
JCFG = jax_lm.TransformerConfig(**WIDTH, dtype=jnp.float32)
PCFG = lm.TransformerConfig(**WIDTH, dtype=torch.float32)
TOKENS = np.random.default_rng(41).integers(0, 128, (2, 33)).astype(np.int32)
SEG = np.array([[0] * 12 + [1] * 21, [0] * 20 + [1] * 13], dtype=np.int32)
# The cap bends the tiny LM's scores (a few units here).
LM_VARIANTS = {"plain": ({}, None), "softcap": (dict(logit_softcap=2.0), None),
               "packed": ({}, SEG)}


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_lm.init_transformer(jax.random.PRNGKey(3), JCFG))


@pytest.mark.parametrize("variant", list(LM_VARIANTS))
def test_lm_with_heads_of_256_matches_jax(jax_params, variant):
    opts, seg = LM_VARIANTS[variant]
    jcfg, pcfg = dataclasses.replace(JCFG, **opts), dataclasses.replace(PCFG, **opts)
    jseg = None if seg is None else jnp.asarray(seg)
    loss_want, grads_want = jax.value_and_grad(lambda p: jax_lm.lm_loss(
        p, jnp.asarray(TOKENS), jcfg, segment_ids=jseg))(jax_params)
    grads_want = dict(_flatten(jax.tree_util.tree_map(np.asarray, grads_want)))
    model = transformer_from_jax(jax_params, pcfg, device="cpu")
    loss = lm.lm_loss(model, torch.from_numpy(TOKENS).long(), pcfg,
                      segment_ids=None if seg is None else torch.from_numpy(seg))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert abs(loss.item() - float(loss_want)) < 1e-5
    assert grads.keys() == grads_want.keys()
    for name, g in grads.items():
        assert_close(g, grads_want[name], BWD_TOL[F32], name)
