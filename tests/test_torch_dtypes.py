"""The port's dtype policy and head dims off 8 -- f32 calls, ``compute_dtype``,
D 111 -- against the JAX package on CPU, and the f32 routes on a simulated
card.

On CPU the port runs its plain versions; the JAX package runs its Pallas
kernels in interpret mode, as its own tests do, on the same numpy inputs.
Budgets: FWD_TOL / BWD_TOL of the compute dtype -- f32 outputs and
gradients agree with JAX within FWD_TOL[f32] (1e-4 abs + 1e-4 rel) and
BWD_TOL[f32] (1e-3 abs + 5e-4 rel); a call computed in bf16 is held, as the
JAX one, against the f32 oracle on the bf16-rounded inputs within FWD_TOL /
BWD_TOL[bf16]; fp16 inputs computed in f32 come back in fp16, so port and
JAX agree within fp16's rounding of O(1) outputs (1e-3 abs + 1e-3 rel).

The f32 kernels run only on the card (``python3 chip_smoke.py``,
``phase_f32_check``, holds them against their plain versions there). On a
"simulated card" the wrappers get meta tensors, their device checks are off
and a stand-in library records every C entry they call, so the route of an
f32 call -- K1's f32 kernel ``fa_fwd_f32`` and the f32 backward
``fa_bwd_f32``, never a bf16 kernel -- is seen without a GPU; the two C
entries' argument packing goes through ctypes stand-ins with their
argtypes (``native.FWD_F32_ARGTYPES`` / ``BWD_F32_ARGTYPES``).
"""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu.ops import oracle as jax_oracle
from flashattn_tpu_torch.ops import f32_split, flash_bwd, flash_bwd_fused, flash_fwd
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, Tolerance, assert_close, make_qkv

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float16: jnp.float16}
FP16_OUT_TOL = Tolerance(1e-3, 1e-3)


def _jax(x):
    return jnp.asarray(x.detach().float().numpy()).astype(JAX_DTYPE[x.dtype])


def _port_grads(q, k, v, do, **kw):
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o = flashattn_tpu_torch.flash_attention(*leaves, **kw)
    return o, torch.autograd.grad(o, leaves, do.to(o.dtype))


def _jax_grads(q, k, v, do, **kw):
    o, vjp = jax.vjp(lambda a, b, c: flashattn_tpu.flash_attention(a, b, c, **kw),
                     *(_jax(x) for x in (q, k, v)))
    return o, vjp(_jax(do).astype(o.dtype))


# (B, Hq, Hkv, Nq, Nk, D, causal): ragged Nq 127 / 129 and Nk 63 / 77, GQA.
F32_CASES = {"Nq127 Nk63 causal GQA": (2, 4, 2, 127, 63, 64, True),
             "Nq129 Nk77 GQA": (1, 4, 2, 129, 77, 32, False),
             "Nq129 Nk63 causal": (2, 2, 2, 129, 63, 40, True)}


@pytest.mark.parametrize("case", list(F32_CASES))
def test_f32_forward_and_gradients_match_jax(case):
    B, Hq, Hkv, Nq, Nk, D, causal = F32_CASES[case]
    q, k, v = make_qkv(600 + Nq, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(700 + Nq, B, Hq, Nq, D)[0]
    o, grads = _port_grads(q, k, v, do, causal=causal)
    o_want, grads_want = _jax_grads(q, k, v, do, causal=causal)
    assert o.dtype == torch.float32
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    for name, g, w in zip(("dq", "dk", "dv"), grads, grads_want):
        assert g.dtype == torch.float32
        assert_close(g, np.asarray(w), BWD_TOL[torch.float32], name)


# (input dtype, compute dtype): fp16 and bf16 opted into f32, f32 opted down
# to bf16.
COMPUTE_CASES = [(torch.float16, torch.float32), (torch.bfloat16, torch.float32),
                 (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("in_dtype,compute", COMPUTE_CASES,
                         ids=[f"{str(a)[6:]} as {str(c)[6:]}" for a, c in COMPUTE_CASES])
def test_compute_dtype_matches_jax(in_dtype, compute):
    """flash_attention(compute_dtype=) against the JAX function with the same
    option: the output and the gradients in the input dtype; computed in f32,
    port and JAX agree within the input dtype's rounding of their f32
    results (f32 compute: FWD_TOL[f32] on bf16 inputs' f32 math before the
    cast back); computed in bf16, both within FWD_TOL / BWD_TOL[bf16] of the
    f32 oracle on the bf16-rounded inputs."""
    q, k, v = (x.to(in_dtype) for x in make_qkv(31, 2, 4, 127, 64, Nk=77, Hkv=2))
    do = make_qkv(32, 2, 4, 127, 64)[0].to(in_dtype)
    kw = dict(causal=True, compute_dtype=compute)
    o, grads = _port_grads(q, k, v, do, **kw)
    o_jax, grads_jax = _jax_grads(q, k, v, do, causal=True,
                                  compute_dtype=JAX_DTYPE[compute])
    assert o.dtype == in_dtype and all(g.dtype == in_dtype for g in grads)
    assert str(o_jax.dtype) == str(in_dtype).split(".")[-1]
    if compute == torch.float32:
        out_tol = FP16_OUT_TOL if in_dtype == torch.float16 else FWD_TOL[torch.bfloat16]
        assert_close(o, np.asarray(o_jax.astype(jnp.float32)), out_tol, "o vs jax")
        exact = [x.float() for x in (q, k, v)]
        want = jax_oracle.attention_reference(*(jnp.asarray(x.numpy()) for x in exact),
                                              causal=True)
        tol = FP16_OUT_TOL if in_dtype == torch.float16 else FWD_TOL[in_dtype]
        assert_close(o, np.asarray(want), tol, "o vs oracle")
        return
    rounded = [x.to(torch.bfloat16).float() for x in (q, k, v)]
    want = jax_oracle.attention_reference(*(jnp.asarray(x.numpy()) for x in rounded),
                                          causal=True)
    assert_close(o, np.asarray(want), FWD_TOL[torch.bfloat16], "port")
    assert_close(np.asarray(o_jax), np.asarray(want), FWD_TOL[torch.bfloat16], "jax")
    for name, g, w in zip(("dq", "dk", "dv"), grads, grads_jax):
        assert_close(g, np.asarray(w.astype(jnp.float32)), BWD_TOL[torch.bfloat16], name)


def test_fp16_in_f32_beats_the_default_bf16_compute():
    """fp16 inputs keep their 10 mantissa bits in f32 and lose 3 in bf16:
    against the f32 oracle, compute_dtype=float32 lands closer."""
    q, k, v = (x.half() for x in make_qkv(33, 1, 4, 200, 64))
    want = flashattn_tpu_torch.attention_reference(*(x.float() for x in (q, k, v)))
    err = [(flashattn_tpu_torch.flash_attention(q, k, v, compute_dtype=c).float() - want)
           .abs().max().item() for c in (torch.float32, None)]
    assert err[0] < FP16_OUT_TOL.atol and err[0] < err[1] / 4, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_111_matches_jax(dtype):
    """D 111 (the reference's adversarial head dim), padded to 112 for the
    kernels: f32 against JAX at FWD_TOL / BWD_TOL[f32]; bf16, port and JAX,
    against the f32 oracle on the bf16 inputs at FWD_TOL / BWD_TOL[bf16];
    the output and gradients keep D 111."""
    q, k, v = (x.to(dtype) for x in make_qkv(34, 1, 4, 129, 111, Nk=77, Hkv=2))
    do = make_qkv(35, 1, 4, 129, 111)[0].to(dtype)
    o, grads = _port_grads(q, k, v, do, causal=True)
    o_jax, grads_jax = _jax_grads(q, k, v, do, causal=True)
    assert o.shape == q.shape and [g.shape for g in grads] == [x.shape for x in (q, k, v)]
    if dtype == torch.float32:
        assert_close(o, np.asarray(o_jax), FWD_TOL[dtype], "o")
        for name, g, w in zip(("dq", "dk", "dv"), grads, grads_jax):
            assert_close(g, np.asarray(w), BWD_TOL[dtype], name)
        return
    ref = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    want = flashattn_tpu_torch.attention_reference(*ref, causal=True)
    want_grads = torch.autograd.grad(want, ref, do.float())
    assert_close(o, want.detach(), FWD_TOL[dtype], "port")
    assert_close(np.asarray(o_jax.astype(jnp.float32)), want.detach(), FWD_TOL[dtype], "jax")
    for name, g, gj, w in zip(("dq", "dk", "dv"), grads, grads_jax, want_grads):
        assert_close(g, w, BWD_TOL[dtype], name)
        assert_close(np.asarray(gj.astype(jnp.float32)), w, BWD_TOL[dtype], f"jax {name}")


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_with_lse"])
@pytest.mark.parametrize("compute", [torch.float16, torch.float64, torch.int8, "float32"])
def test_other_compute_dtypes_raise(fn, compute):
    q, k, v = make_qkv(36, 1, 2, 16, 8)
    with pytest.raises(ValueError, match="compute_dtype must be bfloat16 or float32"):
        getattr(flashattn_tpu_torch, fn)(q, k, v, compute_dtype=compute)


# ---------------------------------------------------------------------------
# The route functions.


@pytest.mark.parametrize("dtype,takes", [(torch.float32, True), (torch.bfloat16, False),
                                         (torch.float16, False)])
def test_f32_route_takes_f32_only(dtype, takes):
    assert flash_fwd.f32_route(dtype=dtype) is takes


# The f32 backward's route without a bias: ``split_sm90_route`` takes f32 as
# it takes bf16 (split_bwd then launches the f32 body); K3's f32 calls
# (neither option) stay K3's, a bias or a head dim above 128 is no route's.
F32_BWD_TAKES = {"f32": {}, "f32 D 8": dict(head_dim=8),
                 "f32 D 112": dict(head_dim=112, segment_ids=None, softcap=30.0)}
F32_BWD_REFUSES = {"neither": dict(segment_ids=None),
                   "bias": dict(bias=torch.empty((1, 1, 1, 8), device="meta")),
                   "D 136": dict(head_dim=136), "fp16": dict(dtype=torch.float16)}
IDS = torch.zeros((1, 8), dtype=torch.int32)


def _f32_bwd_route(head_dim=128, bias=None, dtype=torch.float32, segment_ids=(IDS, IDS),
                   softcap=None):
    return flash_bwd.split_sm90_route(head_dim=head_dim, bias=bias, dtype=dtype,
                                      segment_ids=segment_ids, softcap=softcap)


@pytest.mark.parametrize("case", list(F32_BWD_TAKES))
def test_f32_bwd_route_takes(case):
    assert _f32_bwd_route(**F32_BWD_TAKES[case])


@pytest.mark.parametrize("case", list(F32_BWD_REFUSES))
def test_f32_bwd_route_refuses(case):
    assert not _f32_bwd_route(**F32_BWD_REFUSES[case])


def _fake_cuda(shape, dtype):
    """What the kernel checks read of a tensor, on the card."""
    return types.SimpleNamespace(shape=shape, dtype=dtype,
                                 device=types.SimpleNamespace(type="cuda"))


@pytest.mark.parametrize("kw,what", [(dict(bias=object(), D=136), "head dims above 128"),
                                     (dict(k_scale=object()), "quantized K/V"),
                                     (dict(D=136), "head dims above 128")],
                         ids=["bias", "quantized", "D 136"])
def test_k1_refuses_what_the_f32_route_does_not_take(kw, what):
    """The f32 route's refusals name their f32 rows items; a bias it takes up
    to D 128 (the "bias" case: above D 128, item 5, as without one)."""
    D = kw.pop("D", 128)
    q = _fake_cuda((1, 4, 64, D), torch.float32)
    with pytest.raises(NotImplementedError, match=f"f32 route takes no {what}.*ROADMAP"):
        flash_fwd._check_kernel_args(q, segment_ids=None, bias=kw.get("bias"),
                                     k_scale=kw.get("k_scale"), windowed=False)


def test_the_bias_backward_refuses_f32(monkeypatch):
    """f32 with a bias runs on the f32 body up to D 128; above it the bias
    route refuses it, naming f32 rows item 5."""
    q = torch.empty((1, 2, 16, 136), device="meta")
    stats = torch.empty((1, 2, 16), device="meta")
    bias = torch.empty((1, 1, 1, 16), device="meta")
    monkeypatch.setattr(flash_bwd, "check_kernel_args", lambda q, name: None)
    with pytest.raises(NotImplementedError, match="no float32.*ROADMAP.*f32 rows item 5"):
        flash_bwd.bias_bwd(q, q, q, q, stats, stats, scale=0.125, bias=bias)


def test_the_f32_backward_on_cpu_is_its_plain_version(monkeypatch):
    """The f32 backward's two routes on CPU tensors -- K3 (neither option)
    and the split route (segment ids and / or the cap) -- are their plain
    versions and never reach the kernel library."""
    def no_library():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(native, "kernels", no_library)
    q, k, v = make_qkv(38, 1, 4, 70, 32, Nk=50, Hkv=2)
    do = make_qkv(39, 1, 4, 70, 32)[0]
    o, lse = flash_fwd.fwd(q, k, v, scale=0.2, causal=True)
    delta = (do * o).sum(-1)
    ids = (torch.arange(70)[None] // 30, torch.arange(50)[None] // 30)
    args = (q, k, v, do, lse, delta)
    cases = ((flash_bwd_fused.bwd, flash_bwd_fused.bwd_reference, {}),
             (flash_bwd.split_bwd, flash_bwd.split_bwd_reference, dict(segment_ids=ids)),
             (flash_bwd.split_bwd, flash_bwd.split_bwd_reference,
              dict(softcap=3.0, window=(20, -1))))
    for route, plain, kw in cases:
        got = route(*args, scale=0.2, causal=True, **kw)
        want = plain(*args, scale=0.2, causal=True, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The C entries' argument packing, through ctypes stand-ins with their argtypes.


def _recorder(name, argtypes, seen):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: seen.append((name, args)) or 0)


def _bnhd(*xs):
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2) for x in xs)


@pytest.mark.parametrize("segments", [False, True])
def test_f32_forward_packs_the_c_arguments(segments):
    """fa_fwd_f32 on f32 BNHD views with GQA, a window, offsets, the cap and
    (or not) segment ids at the f32 route's tiles and a bias: K1's dense
    route's argument list, in its order, with the pieces' scratch after lse
    and the bias (None without one) and its strides before the stream."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 200, 150, 64
    q, k, v = _bnhd(*make_qkv(40, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    o, lse = torch.empty_like(q), torch.empty((B, Hq, Nq))
    pieces = f32_split.scratch(B * Hq * Nq, B * Hkv * 140, D, "cpu")
    ids = (torch.arange(Nq).repeat(B, 1) // 50, torch.arange(Nk).repeat(B, 1) // 50)
    seg = (flash_fwd.sm90_segments(ids, Nq, 140, q_tile=flash_fwd.F32_Q_TILE,
                                   kv_tile=flash_fwd.F32_KV_TILE) if segments else None)
    bias, strides = (flash_fwd.sm90_bias(torch.zeros((1, Hq, Nq, Nk))) if segments
                     else (None, (0, 0, 0)))
    seen = []
    lib = types.SimpleNamespace(fa_fwd_f32=_recorder("fa_fwd_f32", native.FWD_F32_ARGTYPES,
                                                     seen))
    rc = flash_fwd._launch_dense_sm90(lib, q, k, v, o, lse, seg, scale=0.125, kv_valid_len=140,
                                      causal=True, window=(100, -1), softcap=30.0, stream=4096,
                                      q_offset=600, kv_offset=200, pieces=pieces, bias=bias,
                                      bias_strides=strides)
    assert rc == 0 and [name for name, _ in seen] == ["fa_fwd_f32"]
    args = seen[0][1]
    assert len(args) == len(native.FWD_F32_ARGTYPES) == 41
    assert args[:6] == tuple(x.data_ptr() for x in (q, k, v, o, lse, pieces))
    assert args[6:10] == ((None,) * 4 if seg is None else tuple(x.data_ptr() for x in seg))
    assert args[10:21] == (B, Hq, Hkv, Nq, D, 140, 1, 100, -1, 600, 200)
    assert args[21:23] == (0.125, 30.0)
    assert args[23:26] == (Nq * Hq * D, D, Hq * D)
    assert args[26:29] == (Nk * Hkv * D, D, Hkv * D)
    assert args[29:32] == args[26:29] and args[32:35] == args[23:26]
    assert args[35] == (Nq if segments else 0) and args[40] == 4096
    # Nk 150 is not a multiple of 4: sm90_bias pads the rows to 152 columns.
    assert args[36:40] == ((bias.data_ptr(), 0, Nq * 152, 152) if segments else (None, 0, 0, 0))


@pytest.mark.parametrize("segments", [False, True])
def test_f32_backward_packs_the_c_arguments(segments):
    """fa_bwd_f32 on f32 BNHD views with GQA, a window, offsets and (or not)
    segment ids at the f32 body's tiles (32-row Q tiles, 64-key KV tiles,
    the query ids padded) and a bias with dbias: the split route's argument
    list, in its order, with the pieces' scratch after dv and the bias,
    dbias (None without them) and the bias's strides before the stream."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 96, 130, 80
    q, k, v = _bnhd(*make_qkv(41, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    do = q.clone()
    stats = torch.zeros((B, Hq, 96))
    dq = torch.zeros((B, Hq, Nq, D))
    dk, dv = torch.empty((B, Hq, Nk, D)), torch.empty((B, Hq, Nk, D))
    pieces = f32_split.scratch(2 * B * Hq * Nq, B * Hkv * 120, D, "cpu")
    ids = (torch.arange(Nq).repeat(B, 1) // 40, torch.arange(Nk).repeat(B, 1) // 40)
    seg = (flash_fwd.sm90_segments(ids, Nq, 120, q_tile=flash_bwd.F32_BWD_Q_TILE,
                                   kv_tile=flash_bwd.F32_BWD_KV_TILE, pad_q=True)
           if segments else None)
    if segments:
        assert seg[0].shape == (B, 96) and seg[1].shape == (B, 128)
        assert seg[2].shape == (B, 3, 2) and seg[3].shape == (B, 2, 2)
    bias = torch.zeros((B, 1, 1, Nk)) if segments else None
    dbias = torch.empty((B, Hq, Nq, Nk)) if segments else None
    _, strides = flash_fwd.kernel_bias(bias)
    seen = []
    lib = types.SimpleNamespace(fa_bwd_f32=_recorder("fa_bwd_f32", native.BWD_F32_ARGTYPES,
                                                     seen))
    rc = flash_bwd._launch_split(lib, q, k, v, do, stats, stats, dq, dk, dv, seg, scale=0.25,
                                 causal=False, kv_valid_len=120, window=(64, 7), softcap=None,
                                 nq_pad=96, stream=4096, q_offset=96, kv_offset=-64,
                                 pieces=pieces, bias=bias, dbias=dbias, bias_strides=strides)
    assert rc == 0 and [name for name, _ in seen] == ["fa_bwd_f32"]
    args = seen[0][1]
    assert len(args) == len(native.BWD_F32_ARGTYPES) == 47
    assert args[:10] == tuple(x.data_ptr()
                              for x in (q, k, v, do, stats, stats, dq, dk, dv, pieces))
    assert args[10:14] == ((None,) * 4 if seg is None else tuple(x.data_ptr() for x in seg))
    assert args[14:24] == (B, Hq, Hkv, Nq, Nk, D, 120, 0, 64, 7)
    assert args[24:27] == (96, -64, 96)  # q_offset, kv_offset, the LSE rows' pitch
    assert args[27:29] == (0.25, 0.0)
    assert args[29:32] == (Nq * Hq * D, D, Hq * D)
    assert args[32:35] == (Nk * Hkv * D, D, Hkv * D)
    assert args[35:38] == args[32:35] and args[38:41] == args[29:32]
    assert args[41:46] == ((bias.data_ptr(), dbias.data_ptr(), Nk, 0, 0) if segments
                           else (None, None, 0, 0, 0))
    assert args[46] == 4096


# ---------------------------------------------------------------------------
# The routes on a simulated card.


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: the wrappers' device checks are off,
    the stand-in library records the name of every C entry called."""
    calls = []
    typed = {"fa_fwd_sm90": native.FWD_SM90_ARGTYPES, "fa_bwd_sm90": native.BWD_SM90_ARGTYPES,
             "fa_bwd_split_sm90": native.BWD_SPLIT_SM90_ARGTYPES,
             "fa_fwd_f32": native.FWD_F32_ARGTYPES, "fa_bwd_f32": native.BWD_F32_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    for name in ("fa_fwd", "fa_decode"):
        setattr(lib, name, lambda *args, name=name: calls.append((name, args)) or 0)
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(flash_bwd, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(flash_bwd_fused, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(flash_fwd, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


# (B, Hq, Hkv, Nq, Nk, D, input dtype, options, the C entries): f32 calls
# take the f32 kernels whatever their options -- the decode-shaped call that
# bf16 sends to the decode kernel too, and a head dim off 8 padded to one;
# fp16 with compute_dtype=f32 likewise; bf16 keeps its Hopper routes.
ROUTES = {
    "f32 causal GQA": (1, 4, 2, 256, 256, 128, torch.float32, dict(causal=True),
                       ["fa_fwd_f32", "fa_bwd_f32"]),
    "f32 packed": (2, 4, 2, 256, 256, 64, torch.float32, dict(causal=True, segment_ids=True),
                   ["fa_fwd_f32", "fa_bwd_f32"]),
    "f32 softcap + window": (1, 4, 2, 256, 256, 64, torch.float32,
                             dict(causal=True, window=(64, -1), logit_softcap=30.0),
                             ["fa_fwd_f32", "fa_bwd_f32"]),
    "f32 decode-shaped": (2, 4, 4, 1, 512, 128, torch.float32, {},
                          ["fa_fwd_f32", "fa_bwd_f32"]),
    "f32 D 111": (1, 4, 2, 129, 77, 111, torch.float32, dict(causal=True),
                  ["fa_fwd_f32", "fa_bwd_f32"]),
    "fp16 as f32": (1, 4, 2, 128, 128, 64, torch.float16,
                    dict(causal=True, compute_dtype=torch.float32),
                    ["fa_fwd_f32", "fa_bwd_f32"]),
    "bf16 causal": (1, 4, 2, 256, 256, 128, torch.bfloat16, dict(causal=True),
                    ["fa_fwd_sm90", "fa_bwd_sm90"]),
    "bf16 D 111": (1, 4, 2, 129, 77, 111, torch.bfloat16, dict(causal=True),
                   ["fa_fwd_sm90", "fa_bwd_sm90"]),
    "f32 as bf16 packed": (2, 4, 2, 256, 256, 64, torch.float32,
                           dict(causal=True, segment_ids=True, compute_dtype=torch.bfloat16),
                           ["fa_fwd_sm90", "fa_bwd_split_sm90"]),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_flash_attention_routes_on_a_simulated_card(card, case):
    B, Hq, Hkv, Nq, Nk, D, dtype, opts, entries = ROUTES[case]
    q = torch.empty((B, Nq, Hq, D), dtype=dtype, device="meta").transpose(1, 2)
    k, v = (torch.empty((B, Nk, Hkv, D), dtype=dtype, device="meta").transpose(1, 2)
            for _ in "kv")
    kw = dict(opts)
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = torch.zeros((B, Nq), dtype=torch.int32, device="meta")
    q.requires_grad_(True)
    before = (flash_fwd.fwd.launches_f32, flash_bwd._f32_bwd_launch.launches,
              flash_bwd_fused.bwd.launches, flash_bwd.split_bwd.launches)
    o = flashattn_tpu_torch.flash_attention(q, k, v, **kw)
    assert o.shape == q.shape and o.dtype == dtype
    o.backward(torch.empty_like(o))
    assert q.grad.shape == q.shape and q.grad.dtype == dtype
    assert [name for name, _ in card] == entries
    d_kernel = -(-D // 8) * 8
    d_arg = 14 if card[0][0] == "fa_fwd_f32" else 13  # fa_fwd_f32 takes its pieces after lse
    assert card[0][1][d_arg] == d_kernel  # the kernels see D padded to a multiple of 8
    f32 = entries[0] == "fa_fwd_f32"
    split = "segment_ids" in kw or "logit_softcap" in kw
    after = (flash_fwd.fwd.launches_f32, flash_bwd._f32_bwd_launch.launches,
             flash_bwd_fused.bwd.launches, flash_bwd.split_bwd.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (
        int(f32), int(f32), int(not split), int(split))
