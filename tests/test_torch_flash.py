"""The port's flash_attention / flash_attention_with_lse and SDPA adapter
against the JAX package on CPU.

On a CPU tensor the port's K1 wrapper runs its plain PyTorch version, and the
JAX package runs its Pallas kernel in interpret mode, as its own tests do.
Tolerances are the package's FWD_TOL budgets: f32 outputs must agree within
FWD_TOL[f32] (1e-4, the f32 kernel budget against the exact oracle); bf16
and fp16 outputs are each held against the f32 oracle at FWD_TOL[bf16]
(2e-2: both frameworks round their inputs and outputs to bf16, so they are
compared through the oracle rather than bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu.ops import oracle as jax_oracle
from flashattn_tpu.ops import sdpa as jax_sdpa
from flashattn_tpu_torch.ops import flash_fwd, oracle, sdpa
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float16: jnp.float16}


def _to_jax(x):
    return jnp.asarray(x.float().numpy()).astype(JAX_DTYPE[x.dtype])


def _layout(x, layout):
    return x if layout == "BHND" else x.transpose(1, 2).contiguous()


# (D, Nk, Hkv) — Hq = 4, Nq = 200; D=111 is the reference's unaligned head dim
F32_CASES = [(d, nk, hkv) for d in (40, 64, 111) for nk in (77, 1234) for hkv in (4, 2)]


@pytest.mark.parametrize("layout", ["BHND", "BNHD"])
@pytest.mark.parametrize("D,Nk,Hkv", F32_CASES)
def test_flash_attention_f32_matches_jax(D, Nk, Hkv, layout):
    q, k, v = make_qkv(D + Nk + Hkv, 2, 4, 200, D, Nk=Nk, Hkv=Hkv)
    q, k, v = (_layout(x, layout) for x in (q, k, v))
    want = flashattn_tpu.flash_attention(*(_to_jax(x) for x in (q, k, v)), layout=layout)
    got = flashattn_tpu_torch.flash_attention(q, k, v, layout=layout)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])


@pytest.mark.parametrize("layout", ["BHND", "BNHD"])
@pytest.mark.parametrize("D,Nk,Hkv", [(40, 1234, 2), (111, 77, 4)])
def test_flash_attention_with_lse_f32_matches_jax(D, Nk, Hkv, layout):
    q, k, v = make_qkv(3 * D + Nk, 1, 4, 130, D, Nk=Nk, Hkv=Hkv)
    q, k, v = (_layout(x, layout) for x in (q, k, v))
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(
        *(_to_jax(x) for x in (q, k, v)), layout=layout)
    o, lse = flashattn_tpu_torch.flash_attention_with_lse(q, k, v, layout=layout)
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 130)
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse, np.asarray(lse_want), FWD_TOL[torch.float32], "lse")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D,Nk,Hkv,layout", [(40, 1234, 2, "BNHD"), (64, 77, 4, "BHND"),
                                            (111, 1234, 4, "BHND")])
def test_flash_attention_low_precision_vs_f32_oracle(dtype, D, Nk, Hkv, layout):
    q, k, v = make_qkv(D + Nk, 1, 4, 200, D, Nk=Nk, Hkv=Hkv, dtype=dtype)
    want = jax_oracle.attention_reference(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))
    q, k, v = (_layout(x, layout) for x in (q, k, v))
    got = flashattn_tpu_torch.flash_attention(q, k, v, layout=layout)
    got_jax = flashattn_tpu.flash_attention(*(_to_jax(x) for x in (q, k, v)), layout=layout)
    assert got.dtype == dtype and got.shape == q.shape
    if layout == "BNHD":
        got, got_jax = got.transpose(1, 2), jnp.swapaxes(got_jax, 1, 2)
    tol = FWD_TOL[dtype]
    assert_close(got, np.asarray(want), tol, "port")
    assert_close(np.asarray(got_jax.astype(jnp.float32)), np.asarray(want), tol, "jax")


_SEG = {"segment_ids": torch.zeros(1, 64, dtype=torch.int32)}
# The JAX options, each raising until its kernel option is ported. The bias,
# the window, the softcap and the q / kv offsets are ported in both
# directions (the window, the softcap and the offsets also with segment ids):
# their cases hold the output and the gradient against the oracle. Offsets
# with a bias still raise.
PORTED = {"bias", "window", "logit_softcap", "segment_ids+window", "segment_ids+logit_softcap",
          "q_offset", "kv_offset", "segment_ids+q_offset", "compute_dtype"}
UNPORTED = {
    "bias": {"bias": torch.zeros(1, 1, 64, 64)},
    "window": {"window": (8, 8)},
    "logit_softcap": {"logit_softcap": 5.0},
    "q_offset": {"causal": True, "q_offset": 3},
    "kv_offset": {"causal": True, "kv_offset": 3},
    "bias+q_offset": {"bias": torch.zeros(1, 1, 64, 64), "causal": True, "q_offset": 3},
    "block_sizes": {"block_sizes": object()},
    "compute_dtype": {"compute_dtype": torch.float32},
    # segment ids are ported; combined with an unported option they still raise
    "segment_ids+bias": {**_SEG, "bias": torch.zeros(1, 1, 64, 64)},
    "segment_ids+window": {**_SEG, "window": (8, 8)},
    "segment_ids+logit_softcap": {**_SEG, "logit_softcap": 5.0},
    "segment_ids+q_offset": {**_SEG, "causal": True, "q_offset": 3},
}


def _oracle_kw(kw):
    """The oracle's spelling of flash_attention's options: a (q_ids, kv_ids)
    tuple for a single segment-id tensor; no ``compute_dtype`` (the oracle
    computes in f32, the dtype these inputs ask for)."""
    kw = {n: x for n, x in kw.items() if n != "compute_dtype"}
    seg = kw.get("segment_ids")
    return kw if seg is None else {**kw, "segment_ids": (seg, seg)}


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_with_lse"])
@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_arguments_raise(fn, name):
    q, k, v = make_qkv(0, 1, 2, 64, 32)
    if name in PORTED:
        out = getattr(flashattn_tpu_torch, fn)(q, k, v, **UNPORTED[name])
        o = out[0] if fn == "flash_attention_with_lse" else out
        assert_close(o, oracle.attention_reference(q, k, v, **_oracle_kw(UNPORTED[name])),
                     FWD_TOL[torch.float32])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(flashattn_tpu_torch, fn)(q, k, v, **UNPORTED[name])


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_arguments_raise_before_a_backward(name):
    """The gradient of an option the kernels do not take yet is refused with
    its ROADMAP item, never computed without it; that of a ported option
    agrees with the oracle's."""
    q, k, v = make_qkv(1, 1, 2, 64, 32)
    q.requires_grad_(True)
    if name in PORTED:
        flashattn_tpu_torch.flash_attention(q, k, v, **UNPORTED[name]).sum().backward()
        qo = q.detach().clone().requires_grad_(True)
        oracle.attention_reference(qo, k, v, **_oracle_kw(UNPORTED[name])).sum().backward()
        assert_close(q.grad, qo.grad, BWD_TOL[torch.float32], "dq")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flashattn_tpu_torch.flash_attention(q, k, v, **UNPORTED[name]).sum().backward()
    assert q.grad is None


def test_validation_errors_match_jax():
    q, k, v = make_qkv(2, 1, 3, 16, 8, Hkv=2)
    with pytest.raises(ValueError, match="GQA"):
        flashattn_tpu_torch.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="layout"):
        flashattn_tpu_torch.flash_attention(q, q, q, layout="NHBD")
    with pytest.raises(ValueError, match="rank-4"):
        flashattn_tpu_torch.flash_attention(q[0], q[0], q[0])


def test_exact_is_faster_equals_jax():
    ns = [1, 16, 77, 128, 129, 512, 1024, 1536, 1537, 2304, 4096, 16384]
    for nq in ns:
        for nk in ns:
            assert sdpa._exact_is_faster(nq, nk) == jax_sdpa._exact_is_faster(nq, nk), (nq, nk)


@pytest.mark.parametrize("impl,N,Nk", [("auto", 256, 77), ("auto", 1600, 1600),
                                       ("exact", 300, 300), ("fused", 300, 200)])
def test_sdpa_matches_jax(impl, N, Nk):
    q, k, v = make_qkv(N + Nk, 1, 2, N, 40, Nk=Nk)
    q, k, v = (_layout(x, "BNHD") for x in (q, k, v))
    want = jax_sdpa.scaled_dot_product_attention(
        *(_to_jax(x) for x in (q, k, v)), layout="BNHD", impl=impl)
    got = sdpa.scaled_dot_product_attention(q, k, v, layout="BNHD", impl=impl)
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])


@pytest.mark.parametrize("impl", ["fused", "exact"])
def test_sdpa_is_causal_matches_jax(impl):
    q, k, v = make_qkv(8, 1, 4, 300, 64, Hkv=2)
    q, k, v = (_layout(x, "BNHD") for x in (q, k, v))
    want = jax_sdpa.scaled_dot_product_attention(
        *(_to_jax(x) for x in (q, k, v)), is_causal=True, layout="BNHD", impl=impl)
    got = sdpa.scaled_dot_product_attention(q, k, v, is_causal=True, layout="BNHD", impl=impl)
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_sdpa_exact_mask_matches_jax(kind):
    q, k, v = make_qkv(9, 1, 2, 100, 32, Nk=77)
    rng = np.random.default_rng(9)
    if kind == "bool":
        mask = rng.random((100, 77)) > 0.3
    else:
        mask = rng.standard_normal((2, 100, 77), dtype=np.float32)
    want = jax_sdpa.scaled_dot_product_attention(
        *(_to_jax(x) for x in (q, k, v)), attn_mask=jnp.asarray(mask))
    got = sdpa.scaled_dot_product_attention(q, k, v, attn_mask=torch.from_numpy(mask))
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])
    # The fused path takes the mask as K1's additive bias.
    fused = sdpa.scaled_dot_product_attention(q, k, v, attn_mask=torch.from_numpy(mask),
                                              impl="fused")
    assert_close(fused, np.asarray(want), FWD_TOL[torch.float32], "fused")


def test_launch_counter_does_not_move_on_cpu():
    before = flash_fwd.fwd.launches
    q, k, v = make_qkv(4, 1, 2, 2304, 40, dtype=torch.bfloat16)
    flashattn_tpu_torch.flash_attention(q, k, v)
    sdpa.scaled_dot_product_attention(q, k, v, impl="fused")
    flash_fwd.fwd(q, k, v, scale=0.1)
    assert flash_fwd.fwd.launches == before


@pytest.mark.parametrize("kv_valid_len", [0, 1, 77, 200])
def test_fwd_kv_valid_len(kv_valid_len):
    """Keys at positions >= kv_valid_len take no part; with none left every
    row is dead (O = 0, LSE = ln2 * mask value), the kernel's convention."""
    q, k, v = make_qkv(5, 1, 4, 96, 40, Nk=200, Hkv=2)
    o, lse = flash_fwd.fwd(q, k, v, scale=0.2, kv_valid_len=kv_valid_len)
    assert o.shape == q.shape and lse.shape == (1, 4, 96)
    if kv_valid_len == 0:
        assert not o.any()
        assert torch.all(lse == np.log(2.0) * oracle.DEFAULT_MASK_VALUE)
        return
    n = kv_valid_len
    o_want, lse_want = jax_oracle.attention_reference_with_lse(
        *(jnp.asarray(x[:, :, :n].numpy()) if i else jnp.asarray(x.numpy())
          for i, x in enumerate((q, k, v))), scale=0.2)
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse, np.asarray(lse_want), FWD_TOL[torch.float32], "lse")
    with pytest.raises(ValueError, match="kv_valid_len"):
        flash_fwd.fwd(q, k, v, scale=0.2, kv_valid_len=201)


def test_fwd_takes_no_plain_path_off_the_cpu():
    """Only a CPU tensor runs the plain version: a tensor on another device
    (here the meta device) gets no silent fallback."""
    q = torch.empty(1, 2, 64, 40, device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="meta"):
        flash_fwd.fwd(q, q, q, scale=0.1)


def test_make_qkv_is_seeded_numpy():
    q, k, v = make_qkv(3, 1, 2, 5, 8, Nk=7, Hkv=1, dtype=torch.bfloat16)
    assert q.shape == (1, 2, 5, 8) and k.shape == v.shape == (1, 1, 7, 8)
    assert q.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    assert torch.equal(q, torch.from_numpy(
        rng.standard_normal((1, 2, 5, 8), dtype=np.float32)).to(torch.bfloat16))
    assert torch.equal(make_qkv(3, 1, 2, 5, 8)[0], make_qkv(3, 1, 2, 5, 8)[0])
