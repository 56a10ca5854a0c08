"""A bias above head dim 128 -- K1's bias route's and K5 + K6's D 256 forms
(``csrc/fwd_sm90_tile.cuh``'s bias slot, ``csrc/bwd_sm90_wide.cuh``'s BIAS
family) -- against the JAX package on CPU.

The kernels run only on the card (``python3 chip_smoke.py``:
``phase_wide_bias_check`` holds them against their plain versions there,
``phase_wide_bias_train`` trains path A with heads of 256). Here:

* ``flash_attention(bias=)`` at D 136 / 192 / 256 -- the port's plain K1 and
  its plain bias backward on CPU tensors -- against the JAX
  ``flash_attention`` and ``jax.vjp`` (its Pallas K1 / K5 / K6 in interpret
  mode) on the same numpy inputs: O within FWD_TOL[f32], dQ, dK, dV and
  dbias (summed over the bias's broadcast dims, as both return it) within
  BWD_TOL[f32]; with no option, causal, a window (a padding bias: dead rows),
  segment ids, offsets, the cap, GQA, ragged Nq / Nk, Nq 1, every option at
  once, and every broadcast shape of the bias;
* a KV tail (kv_valid_len < Nk, which the JAX function has no argument for)
  through the plain versions against the JAX function on K / V cut to the
  valid keys: dbias 0 on the cut keys, dK / dV rows past the tail 0;
* the torch.nn module with 2 heads of 256 and a key-padding mask against the
  flax module;
* on a simulated card (meta tensors, the device checks off, a stand-in
  library recording each C entry's arguments): the C arguments of both D 256
  forms and of K1's quantized route (``fa_fwd_quant_sm90``), the routes' head
  dims, and the counters ``fwd.launches_bias_d256`` /
  ``bias_bwd.launches_d256``.
"""

import contextlib
import ctypes
import itertools
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
from flashattn_tpu.integrations import flax_linen
import flashattn_tpu_torch
from flashattn_tpu_torch.integrations import make_attention_mask
from flashattn_tpu_torch.models.convert import mhdpa_from_flax
from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

F32 = torch.float32
F32_FWD, F32_BWD = FWD_TOL[F32], BWD_TOL[F32]


def _bias(kind, seed, B, Hq, Nq, Nk):
    """An f32 numpy bias: "padding" the key-padding bias [B, 1, Nq, Nk] of
    lengths (Nq, 0.6 Nq) (dead rows), else a normal bias with the (batch,
    head, row) dims that ``kind`` flags, 1 on the others."""
    if kind == "padding":
        lengths = np.array([Nq, int(0.6 * Nq)])[:B]
        keep_q = np.arange(Nq)[None] < lengths[:, None]
        keep_k = np.arange(Nk)[None] < lengths[:, None]
        pair = keep_q[:, None, :, None] & keep_k[:, None, None, :]
        return np.where(pair, 0.0, DEFAULT_MASK_VALUE).astype(np.float32)
    shape = tuple(n if f else 1 for n, f in zip((B, Hq, Nq), kind)) + (Nk,)
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _ids(seed, B, N):
    """Sorted packed ids [B, N]: three runs of random lengths."""
    rng = np.random.default_rng(seed)
    out = np.zeros((B, N), np.int32)
    for row in out:
        for c in np.sort(rng.choice(np.arange(1, N), 2, replace=False)):
            row[c:] += 1
    return out


# (name, B, Hq, Hkv, Nq, Nk, D, bias, options): D 136 and 192 run in the
# kernels' 256 box.
CASES = [
    ("D 256", 2, 2, 2, 64, 64, 256, (1, 1, 1), {}),
    ("D 136 causal", 1, 2, 2, 96, 96, 136, (0, 1, 1), dict(causal=True)),
    ("D 192 window, padding bias", 2, 2, 1, 80, 80, 192, "padding", dict(window=(16, 8))),
    ("D 256 segment ids", 2, 2, 2, 96, 96, 256, (1, 0, 0), dict(segment_ids=True)),
    ("D 136 causal offsets", 1, 2, 1, 64, 96, 136, (1, 1, 1),
     dict(causal=True, q_offset=48, kv_offset=16)),
    ("D 192 softcap 50", 1, 2, 2, 64, 64, 192, (0, 0, 1), dict(logit_softcap=50.0)),
    ("D 256 GQA 2", 1, 4, 2, 64, 64, 256, (0, 1, 1), dict(causal=True)),
    ("D 136 ragged Nq 70, Nk 90", 2, 2, 1, 70, 90, 136, (1, 0, 1), {}),
    ("D 256 Nq 1", 2, 4, 2, 1, 80, 256, (1, 1, 1), {}),
    ("D 192 everything", 2, 2, 1, 96, 96, 192, (1, 1, 1),
     dict(causal=True, window=(40, -1), segment_ids=True, logit_softcap=5.0)),
]
# Every broadcast shape of the bias [B|1, H|1, Nq|1, Nk] at D 256.
BROADCASTS = [("D 256 bias " + "".join("BHQ"[i] if f else "1" for i, f in enumerate(dims)),
               2, 2, 2, 48, 48, 256, dims, {})
              for dims in itertools.product((0, 1), repeat=3)]


def _inputs(case):
    name, B, Hq, Hkv, Nq, Nk, D, kind, opts = case
    seed = sum(map(ord, name))
    q, k, v = make_qkv(seed, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(seed + 1, B, Hq, Nq, D)[0]
    kw = dict(opts)
    if kw.get("segment_ids"):
        kw["segment_ids"] = _ids(seed + 3, B, Nq)
    return q, k, v, do, _bias(kind, seed + 2, B, Hq, Nq, Nk), kw


def _jax(q, k, v, do, bias, kw):
    """The JAX flash_attention's O and jax.vjp's (dQ, dK, dV, dbias)."""
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    o, vjp = jax.vjp(lambda a, b, c, d: flashattn_tpu.flash_attention(a, b, c, bias=d, **jkw),
                     *(jnp.asarray(np.asarray(x)) for x in (q, k, v, bias)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]


def _port(q, k, v, do, bias, kw):
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    leaves.append(torch.from_numpy(bias).requires_grad_(True))
    o = flashattn_tpu_torch.flash_attention(*leaves[:3], bias=leaves[3], **tkw)
    return o.detach(), torch.autograd.grad(o, leaves, do)


@pytest.mark.parametrize("case", CASES + BROADCASTS, ids=[c[0] for c in CASES + BROADCASTS])
def test_wide_bias_matches_jax(case):
    q, k, v, do, bias, kw = _inputs(case)
    o, grads = _port(q, k, v, do, bias, kw)
    want_o, want_g = _jax(q, k, v, do, bias, kw)
    assert_close(o, want_o, F32_FWD, "O")
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), grads, want_g):
        assert tuple(got.shape) == want.shape, name
        assert_close(got, want, F32_BWD, name)
    if case[7] == "padding":  # dead rows: O and their gradients exactly 0
        dead = torch.from_numpy(bias[:, 0].max(-1) <= DEFAULT_MASK_VALUE)
        dead = dead[:, None].expand(-1, q.shape[1], -1)
        assert dead.any() and (o[dead] == 0).all() and (grads[0][dead] == 0).all()


@pytest.mark.parametrize("D", [136, 192, 256])
def test_kv_tail_matches_jax_on_the_valid_keys(D):
    """kv_valid_len 50 of Nk 64 (GQA 4/2, a [B, H, Nq, Nk] bias): the plain K1
    and bias backward (the kernels' plain versions, the backward's dK / dV
    per KV head) against the JAX function on K / V and the bias cut to the
    50 valid keys; dbias exactly 0 on the cut keys, their dK / dV rows 0."""
    B, Hq, Hkv, Nq, Nk, kvl = 2, 4, 2, 40, 64, 50
    q, k, v = make_qkv(D, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(D + 1, B, Hq, Nq, D)[0]
    bias = _bias((1, 1, 1), D + 2, B, Hq, Nq, Nk)
    scale = D ** -0.5
    o, lse = flash_fwd.fwd(q, k, v, scale=scale, kv_valid_len=kvl, bias=torch.from_numpy(bias))
    dq, dk, dv, dbias = flash_bwd.bias_bwd(q, k, v, do, lse, (do * o).sum(-1), scale=scale,
                                           kv_valid_len=kvl, bias=torch.from_numpy(bias),
                                           want_dbias=True)
    want_o, want_g = _jax(q, k[:, :, :kvl], v[:, :, :kvl], do, bias[..., :kvl], {})
    assert_close(o, want_o, F32_FWD, "O")
    for name, got, want in zip(("dq", "dk", "dv", "dbias"),
                               (dq, dk[:, :, :kvl], dv[:, :, :kvl], dbias[..., :kvl]), want_g):
        assert_close(got, want, F32_BWD, name)
    assert (dbias[..., kvl:] == 0).all() and (dk[:, :, kvl:] == 0).all()
    assert (dv[:, :, kvl:] == 0).all()


def test_module_with_heads_of_256_and_a_mask_matches_flax():
    """FlashMultiHeadDotProductAttention with 2 heads of 256 and a key-padding
    mask (the mask becomes a bias: flash_attention(bias=) at D 256) against
    the flax module with the same mask, the weights carried across: the
    output on the valid rows within 2e-5 and every parameter's gradient
    within 5e-4 (tests/test_torch_integration.py's budgets)."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 48, 32), dtype=np.float32)
    valid = np.arange(48)[None] < np.array([[48], [30]])
    ref = flax_linen.FlashMultiHeadDotProductAttention(num_heads=2, qkv_features=512)
    params = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(32), x))
    mask = nn.make_attention_mask(valid, valid)

    def loss_jax(p):
        y = ref.apply(p, x, mask=mask)
        return ((y ** 2) * valid[..., None]).sum(), y

    (_, y_want), g_want = jax.value_and_grad(loss_jax, has_aux=True)(params)
    mod = mhdpa_from_flax(params, num_heads=2, impl="fused", device="cpu")
    assert mod.query.kernel.shape[-1] == 256
    tmask = make_attention_mask(torch.from_numpy(valid), torch.from_numpy(valid),
                                dtype=torch.bool)
    y = mod(torch.from_numpy(x), mask=tmask)
    ((y ** 2) * torch.from_numpy(valid)[..., None]).sum().backward()
    assert float(np.abs(y.detach().numpy()[valid] - np.asarray(y_want)[valid]).max()) < 2e-5
    grads = dict(mod.named_parameters())
    for proj, leaves in g_want["params"].items():
        for leaf, want in leaves.items():
            diff = np.abs(grads[f"{proj}.{leaf}"].grad.numpy() - np.asarray(want)).max()
            assert diff < 5e-4, f"{proj}.{leaf}"


# ---------------------------------------------------------------------------
# The simulated card.


def _recorder(name, argtypes, calls):
    """A ctypes function with the C entry's argument types (so ctypes
    converts the arguments as it would for the real entry) that records
    them."""
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: calls.append((name, args)) or 0)


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: the device checks are off (the
    backward keeps its head-dim and dtype checks), and the stand-in library
    records the name and arguments of every C entry called."""
    calls = []
    typed = {"fa_fwd_quant_sm90": native.FWD_QUANT_SM90_ARGTYPES,
             "fa_fwd_sm90": native.FWD_SM90_ARGTYPES,
             "fa_fwd_bias_sm90": native.FWD_BIAS_SM90_ARGTYPES,
             "fa_bwd_bias_sm90": native.BWD_BIAS_SM90_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    lib.fa_decode = lambda *args: calls.append(("fa_decode", args)) or 0
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(flash_bwd, "check_kernel_args", flash_bwd.check_kernel_dims)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


def _meta_qkv(B, Hq, Hkv, Nq, Nk, D, kv_dtype=torch.bfloat16):
    """q / k / v as [B, H, N, D] views of [B, N, H, D] meta tensors."""
    q = torch.empty((B, Nq, Hq, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
    k, v = (torch.empty((B, Nk, Hkv, D), dtype=kv_dtype, device="meta").transpose(1, 2)
            for _ in "kv")
    return q, k, v


def _counters():
    return (flash_fwd.fwd.launches_bias_sm90, flash_fwd.fwd.launches_bias_d256,
            flash_bwd.bias_bwd.launches, flash_bwd.bias_bwd.launches_d256,
            flash_bwd.bias_bwd.launches_dbias)


def test_the_d256_forward_packs_its_c_arguments(card):
    """K1 with a [B, 1, Nq, Nk] bias, segment ids, a window and the cap at D
    256 (BNHD views, GQA 4/2): one fa_fwd_bias_sm90 call, D 256, the band,
    the cap, the bias's strides (0 on its head dim) and the ids' pointers
    and batch stride in the C entry's typed order; counted as the bias
    route's and its D 256 form's launch."""
    B, Hq, Hkv, N, D = 2, 4, 2, 300, 256
    q, k, v = _meta_qkv(B, Hq, Hkv, N, N, D)
    bias = torch.zeros((B, 1, N, N), device="meta")
    ids = torch.zeros((B, N), dtype=torch.int32, device="meta")
    before = _counters()
    o, lse = flash_fwd.fwd(q, k, v, scale=0.0625, bias=bias, segment_ids=(ids, ids),
                           window=(100, 20), softcap=30.0)
    assert [name for name, _ in card] == ["fa_fwd_bias_sm90"]
    args = card[0][1]
    assert len(args) == len(native.FWD_BIAS_SM90_ARGTYPES) == 40
    assert args[10:21] == (B, Hq, Hkv, N, D, N, 0, 100, 20, 0, 0)
    assert args[21] == 0.0625 and args[22] == pytest.approx(30.0)
    assert args[35:38] == (N * N, 0, N)  # the bias's (batch, head, row) strides
    assert args[38] == N  # seg_q's batch stride
    assert o.shape == q.shape and lse.shape == (B, Hq, N)
    assert _counters()[:2] == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("want_dbias", [False, True], ids=["no dbias", "dbias"])
def test_the_d256_backward_packs_its_c_arguments(card, want_dbias):
    """K5 + K6 with a [1, Hq, Nq, Nk] bias at D 200 (run in the 256 box),
    causal GQA 4/2, Nq 130: one fa_bwd_bias_sm90 call with D 200, the KV
    head count, LSE / Δ rows padded to 64 and the bias's strides (rows of
    150 keys padded to 152, 16 bytes, as at D <= 128); dK / dV
    come back per KV head (the D 256 form writes them per query head, the
    wrapper sums each group); counted as a D 256 launch, with dbias as
    one that wrote it."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 130, 150, 200
    q, k, v = _meta_qkv(B, Hq, Hkv, Nq, Nk, D)
    stats = torch.empty((B, Hq, Nq), device="meta")
    bias = torch.zeros((1, Hq, Nq, Nk), device="meta")
    before = _counters()
    dq, dk, dv, dbias = flash_bwd.bias_bwd(q, k, v, q, stats, stats, scale=0.07, causal=True,
                                           bias=bias, want_dbias=want_dbias)
    assert [name for name, _ in card] == ["fa_bwd_bias_sm90"]
    args = card[0][1]
    assert len(args) == len(native.BWD_BIAS_SM90_ARGTYPES) == 46
    assert args[15:23] == (B, Hq, Hkv, Nq, Nk, D, Nk, 1)
    assert args[27] == 192  # LSE / Δ rows padded to 64
    assert args[42:45] == (0, Nq * 152, 152)  # its rows padded to 16 bytes (sm90_bias)
    assert dq.shape == (B, Hq, Nq, D) and dk.shape == dv.shape == (B, Hkv, Nk, D)
    assert (dbias is not None) == want_dbias and (not want_dbias or dbias.shape ==
                                                  (B, Hq, Nq, Nk))
    assert _counters()[2:] == (before[2] + 1, before[3] + 1, before[4] + want_dbias)


def test_fa_fwd_takes_only_quantized_kv(card):
    """A quantized call with a bias above D 128 reaches K1's quantized route
    (fa_fwd_quant_sm90, which took over from the mma.sync fa_fwd) with its
    K/V code, D and bias, and no cap argument; the same call on bf16 K/V
    reaches K1's bias route's D 256 form."""
    B, Hq, Hkv, N, D = 1, 4, 2, 96, 160
    bias = torch.zeros((1, 1, 1, N), device="meta")
    q, k, v = _meta_qkv(B, Hq, Hkv, N, N, D, kv_dtype=torch.int8)
    scales = [torch.ones((B, Hkv, N), device="meta") for _ in "kv"]
    flash_fwd.fwd(q, k, v, scale=0.1, bias=bias, k_scale=scales[0], v_scale=scales[1])
    q, k, v = _meta_qkv(B, Hq, Hkv, N, N, D)
    flash_fwd.fwd(q, k, v, scale=0.1, bias=bias)
    assert [name for name, _ in card] == ["fa_fwd_quant_sm90", "fa_fwd_bias_sm90"]
    args = card[0][1]
    assert len(args) == len(native.FWD_QUANT_SM90_ARGTYPES) == 48  # no cap argument
    assert args[12] == flash_fwd.KV_DTYPE_CODE[torch.int8] and args[17] == D
    assert args[24] == pytest.approx(0.1) and args[37:40] == (0, 0, 0)  # the [1, 1, 1, N] bias


@pytest.mark.parametrize("D", [136, 192, 256])
def test_routes_take_a_bf16_bias_up_to_d256(D):
    """bias_route and bias_bwd_route take a bf16 bias at every head dim up
    to 256, with a band and ids too; bias_bwd_route an f32 one too (f32
    stopped at 128 until the f32 body's D 256 form)."""
    N = 512
    bias = torch.empty((1, 1, N, N), device="meta")
    assert flash_fwd.bias_route(rows=2 * N, causal=True, segment_ids=None, window=(64, -1),
                                head_dim=D, bias=bias, kv_dtype=torch.bfloat16)
    assert flash_bwd.bias_bwd_route(head_dim=D, bias=bias, dtype=torch.bfloat16)
    assert flash_bwd.bias_bwd_route(head_dim=D, bias=bias, dtype=torch.float32)


def test_routes_refuse_a_bias_above_d256():
    bias = torch.empty((1, 1, 64, 64), device="meta")
    assert not flash_fwd.bias_route(rows=64, causal=False, segment_ids=None, window=None,
                                    head_dim=264, bias=bias, kv_dtype=torch.bfloat16)
    assert not flash_bwd.bias_bwd_route(head_dim=264, bias=bias, dtype=torch.bfloat16)


@pytest.mark.parametrize("D", [128, 136])
def test_only_the_d256_forms_count_as_d256(card, D):
    """flash_attention with a learned bias: at D 128 the bias routes' D 128
    forms, at D 136 their D 256 forms, each counted once (dbias too)."""
    q, k, v = (x.requires_grad_(True) for x in _meta_qkv(1, 4, 2, 128, 128, D))
    bias = torch.zeros((1, 4, 128, 128), device="meta", requires_grad=True)
    before = _counters()
    o = flashattn_tpu_torch.flash_attention(q, k, v, bias=bias, causal=True)
    grads = torch.autograd.grad(o, (q, k, v, bias), torch.empty_like(o))
    assert [name for name, _ in card] == ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape, bias.shape]
    wide = int(D > 128)
    assert _counters() == (before[0] + 1, before[1] + wide, before[2] + 1, before[3] + wide,
                           before[4] + 1)
