"""q / kv offsets on the port's attention against the JAX package.

``flash_attention(q_offset=, kv_offset=)`` -- the chunk pairs of the
sequence-parallel paths -- runs K1's dense route and, in its backward, K3 or
K5 + K6's split route on the card, each with its band shifted by ``q_offset
- kv_offset`` (csrc/common.cuh band_bounds). On the CPU the same calls take
the plain versions, which are held here against the JAX ``flash_attention``
(its Pallas kernels in interpret mode) with the same offsets, forward and
``jax.grad``; the plain K1 / K3 / split route alone against the JAX K1 and
the JAX backward (K3, or K5 + K6 with segment ids) through ``jax.vjp``; the
C arguments through ctypes stand-ins with the entries' argtypes on a
simulated card; and the refusals that remain. Inputs are drawn in f32 with
numpy from a seed; budgets FWD_TOL / BWD_TOL[f32], the package's f32
budgets.

Where offsets leave rows that see no key, the JAX ``flash_attention`` gives
those rows zeros but a nonzero dQ (and the dK / dV it implies), where its
own docstring and its oracle give them zero gradients: a deviation of the
reference (ROADMAP queue 3), shown by
``test_jax_dead_row_gradients_deviate_from_its_oracle``. The gradients of
such cases are held against ``jax.grad`` of the JAX oracle
(``flashattn_tpu.ops.oracle.attention_reference``) with the same offsets.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import flashattn_tpu_torch
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

F32_FWD, F32_BWD = FWD_TOL[torch.float32], BWD_TOL[torch.float32]


def _ids(seed, B, N, n_segs=3):
    """Sorted packed ids [B, N] with n_segs runs of random lengths."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, N), n_segs - 1, replace=False))
    row = np.zeros(N, np.int32)
    for c in cuts:
        row[c:] += 1
    return torch.from_numpy(np.tile(row, (B, 1)))


# (name, B, Hq, Hkv, Nq, Nk, D, options, q_offset, kv_offset): delta = q_offset
# - kv_offset zero, negative (rows before it see no key: dead rows) and
# larger than Nk (every pair live, the band never cuts), causal, a causal
# window whose left edge cuts the tiles, a two-sided window with delta < 0,
# segment ids (one array and a tuple with Nq != Nk), GQA 4/1, Nq != Nk.
CASES = [
    ("causal delta 0", 1, 2, 2, 128, 128, 32, dict(causal=True), 96, 96),
    ("causal delta > Nk", 1, 2, 2, 128, 128, 32, dict(causal=True), 384, 0),
    ("causal delta < 0", 2, 4, 2, 128, 128, 32, dict(causal=True), 0, 64),
    ("window", 1, 4, 2, 128, 128, 32, dict(causal=True, window=(60, -1)), 200, 100),
    ("two-sided window delta < 0", 1, 2, 2, 96, 160, 32, dict(window=(20, 30)), 40, 90),
    ("segment ids", 2, 2, 2, 128, 128, 32, dict(causal=True, segment_ids="one"), 128, 0),
    ("segment ids Nq != Nk", 1, 2, 1, 96, 160, 32, dict(causal=True, segment_ids="tuple"),
     200, 64),
    ("GQA 4/1", 1, 4, 1, 128, 128, 64, dict(causal=True), 64, 0),
    ("Nq > Nk", 1, 2, 2, 160, 96, 32, dict(causal=True), 32, 100),
]


def _inputs(case):
    name, B, Hq, Hkv, Nq, Nk, D, opts, qo, ko = case
    seed = sum(map(ord, name))
    q, k, v = make_qkv(seed, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(seed + 1, B, Hq, Nq, D)[0]
    kw = dict(opts)
    ids = kw.pop("segment_ids", None)
    if ids == "one":
        kw["segment_ids"] = _ids(seed, B, Nq)
    elif ids == "tuple":
        kw["segment_ids"] = (_ids(seed, B, Nq), _ids(seed + 2, B, Nk))
    return q, k, v, do, kw, qo, ko


def _jax_kw(kw):
    import jax.numpy as jnp

    seg = kw.get("segment_ids")
    if seg is None:
        return kw
    seg = tuple(jnp.asarray(s.numpy()) for s in seg) if isinstance(seg, tuple) else \
        jnp.asarray(seg.numpy())
    return {**kw, "segment_ids": seg}


def _dead_rows(q, k, kw, qo, ko) -> bool:
    """Whether some query row sees no key under these masks and offsets."""
    seg = kw.get("segment_ids")
    ids = None if seg is None else (seg if isinstance(seg, tuple) else (seg, seg))
    keep = flash_fwd.pair_mask(q.shape[2], k.shape[2], kv_valid_len=k.shape[2],
                               causal=kw.get("causal", False), segment_ids=ids,
                               device="cpu", window=kw.get("window"), q_offset=qo,
                               kv_offset=ko)
    return not bool(keep.any(-1).all())


def _jax_grads(q, k, v, do, kw, qo, ko, fn=None):
    """A JAX attention's output and jax.grad of <O, dO>, as numpy: the JAX
    flash_attention, or ``fn`` (the JAX oracle, with its spelling of the
    segment ids)."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.ops.flash import flash_attention

    args = [jnp.asarray(x.numpy()) for x in (q, k, v)]
    g = jnp.asarray(do.numpy())
    jkw = _jax_kw(kw)
    if fn is not None:
        seg = jkw.get("segment_ids")
        if seg is not None and not isinstance(seg, tuple):
            jkw = {**jkw, "segment_ids": (seg, seg)}
    fn = fn or flash_attention
    o = fn(*args, q_offset=qo, kv_offset=ko, **jkw)
    grads = jax.grad(lambda a, b, c: jnp.sum(
        fn(a, b, c, q_offset=qo, kv_offset=ko, **jkw) * g), argnums=(0, 1, 2))(*args)
    return np.asarray(o), [np.asarray(x) for x in grads]


def _jax_oracle():
    from flashattn_tpu.ops.oracle import attention_reference

    return attention_reference


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_offsets_match_jax(case):
    """flash_attention with offsets, its output and its gradients (autograd
    through _FlashCore: K3's plain version without ids, the split route's
    with them) against the JAX function with the same offsets (the
    gradients, where rows see no key, against the JAX oracle's)."""
    q, k, v, do, kw, qo, ko = _inputs(case)
    want_o, want_g = _jax_grads(q, k, v, do, kw, qo, ko)
    if _dead_rows(q, k, kw, qo, ko):
        _, want_g = _jax_grads(q, k, v, do, kw, qo, ko, fn=_jax_oracle())
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = flashattn_tpu_torch.flash_attention(*leaves, q_offset=qo, kv_offset=ko, **kw)
    got_g = torch.autograd.grad(o, leaves, do)
    assert_close(o.detach(), want_o, F32_FWD, "O")
    for name, got, want in zip(("dq", "dk", "dv"), got_g, want_g):
        assert_close(got, want, F32_BWD, name)


def test_offsets_as_0d_tensors_and_with_lse():
    """Offsets as 0-d integer tensors (read once with .item()) give what host
    ints give; flash_attention_with_lse takes them too (its LSE against the
    JAX function's)."""
    from flashattn_tpu.ops.flash import flash_attention_with_lse as jax_with_lse
    import jax.numpy as jnp

    q, k, v, _, kw, qo, ko = _inputs(CASES[3])
    ints = flashattn_tpu_torch.flash_attention(q, k, v, q_offset=qo, kv_offset=ko, **kw)
    tens = flashattn_tpu_torch.flash_attention(q, k, v, q_offset=torch.tensor(qo),
                                               kv_offset=torch.tensor(ko, dtype=torch.int32),
                                               **kw)
    assert torch.equal(ints, tens)
    o, lse = flashattn_tpu_torch.flash_attention_with_lse(q, k, v, q_offset=qo, kv_offset=ko,
                                                          **kw)
    jo, jlse = jax_with_lse(*(jnp.asarray(x.numpy()) for x in (q, k, v)), q_offset=qo,
                            kv_offset=ko, **kw)
    assert_close(o, np.asarray(jo), F32_FWD, "O")
    assert_close(lse, np.asarray(jlse), F32_FWD, "LSE")


@pytest.mark.parametrize("opts", [dict(causal=True), dict(causal=True, window=(40, -1)),
                                  dict(window=(16, 16), segment_ids=True)],
                         ids=["causal", "window", "two-sided window + ids"])
def test_equal_offsets_are_the_call_without(opts):
    """q_offset == kv_offset is the call without offsets, bit for bit: the
    output and every gradient (and so is any offset without a band)."""
    q, k, v = make_qkv(31, 1, 4, 96, 32, Hkv=2)
    kw = dict(opts)
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = _ids(31, 1, 96)
    results = []
    for offs in ({}, dict(q_offset=700, kv_offset=700)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = flashattn_tpu_torch.flash_attention(*leaves, **offs, **kw)
        results.append((o, *torch.autograd.grad(o.square().sum(), leaves)))
    for a, b in zip(*results):
        assert torch.equal(a, b)
    free = flashattn_tpu_torch.flash_attention(q, k, v, q_offset=5, kv_offset=900)
    assert torch.equal(free, flashattn_tpu_torch.flash_attention(q, k, v))


# ---------------------------------------------------------------------------
# The plain K1 / K3 / split route with offsets against the JAX kernels.

PLAIN_CASES = [c for c in CASES if c[0] in ("causal delta < 0", "window",
                                            "two-sided window delta < 0", "segment ids",
                                            "Nq > Nk")]


@pytest.mark.parametrize("case", PLAIN_CASES, ids=[c[0] for c in PLAIN_CASES])
def test_plain_versions_with_offsets_match_jax(case):
    """fwd_reference (K1's plain version) against the JAX K1
    (flash_attention_with_lse), then bwd_reference (K3's) or
    split_bwd_reference (the split route's, with ids) on that LSE against
    jax.vjp of the JAX flash_attention (K3, or K5 + K6 with ids): dK / dV per
    query head, summed over each KV head's group as _FlashCore sums them
    (where rows see no key: jax.vjp of the JAX oracle)."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.ops.flash import flash_attention, flash_attention_with_lse

    q, k, v, do, kw, qo, ko = _inputs(case)
    B, Hq, Nq, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    seg = kw.pop("segment_ids", None)
    ids = None if seg is None else (seg if isinstance(seg, tuple) else (seg, seg))
    scale = D ** -0.5
    kernel_kw = dict(scale=scale, q_offset=qo, kv_offset=ko, **kw)
    o, lse = flash_fwd.fwd_reference(q, k, v, segment_ids=ids, **kernel_kw)
    args = [jnp.asarray(x.numpy()) for x in (q, k, v)]
    jkw = _jax_kw({**kw, **({} if ids is None else {"segment_ids": ids})})
    jo, jlse = flash_attention_with_lse(*args, q_offset=qo, kv_offset=ko, **jkw)
    assert_close(o, np.asarray(jo), F32_FWD, "O")
    live = lse > 0.5 * np.log(2.0) * flash_fwd.DEFAULT_MASK_VALUE
    assert_close(lse[live], np.asarray(jlse)[live.numpy()], F32_FWD, "LSE")
    delta = (do * o).sum(-1)
    if ids is None:
        got = flash_bwd_fused.bwd_reference(q, k, v, do, lse, delta, **kernel_kw)
    else:
        got = flash_bwd.split_bwd_reference(q, k, v, do, lse, delta, segment_ids=ids,
                                            **kernel_kw)
    fn = flash_attention
    if _dead_rows(q, k, {**kw, "segment_ids": ids}, qo, ko):
        fn = _jax_oracle()
        jkw = _jax_kw({**kw, **({} if ids is None else {"segment_ids": ids})})
    _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, q_offset=qo, kv_offset=ko, **jkw), *args)
    want = vjp(jnp.asarray(do.numpy()))
    dq, dk, dv = got
    dk, dv = (x.view(B, Hkv, Hq // Hkv, Nk, D).sum(2) for x in (dk, dv))
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert_close(a, np.asarray(b), F32_BWD, name)


def test_jax_dead_row_gradients_deviate_from_its_oracle():
    """The reference's deviation: with offsets that leave rows before the
    first key (causal, kv_offset 64), the JAX flash_attention's output is 0
    there but its dQ is not, while jax.grad of the JAX oracle -- and the
    port -- give those rows zero gradients."""
    q, k, v, do, kw, _, _ = _inputs(CASES[2])
    _, got = _jax_grads(q, k, v, do, kw, 0, 64)
    _, oracle = _jax_grads(q, k, v, do, kw, 0, 64, fn=_jax_oracle())
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = flashattn_tpu_torch.flash_attention(*leaves, q_offset=0, kv_offset=64, **kw)
    port = torch.autograd.grad(o, leaves, do)
    dead = slice(0, 64)
    assert np.abs(got[0][:, :, dead]).max() > 1.0
    assert (oracle[0][:, :, dead] == 0).all() and (port[0][:, :, dead] == 0).all()
    assert_close(port[0], oracle[0], F32_BWD, "dq")


def test_a_kv_tile_no_row_reaches_gets_zero_gradients():
    """With delta < 0 the keys past the last row's reach get no gradient: dK
    and dV exactly 0 there, as the kernels write a KV tile whose Q range is
    empty; the rows that see no key get dQ exactly 0."""
    q, k, v = make_qkv(44, 1, 2, 64, 32, Nk=256)
    do = make_qkv(45, 1, 2, 64, 32)[0]
    o, lse = flash_fwd.fwd_reference(q, k, v, scale=32 ** -0.5, causal=True, q_offset=0,
                                     kv_offset=-100)
    delta = (do * o).sum(-1)
    dq, dk, dv = flash_bwd_fused.bwd_reference(q, k, v, do, lse, delta, scale=32 ** -0.5,
                                               causal=True, q_offset=0, kv_offset=-100)
    # row i sees keys j <= i + 100: keys 164.. are past every row's reach
    assert (dk[:, :, 164:] == 0).all() and (dv[:, :, 164:] == 0).all()
    assert dk[:, :, :164].abs().amax() > 0
    o2, lse2 = flash_fwd.fwd_reference(q, k, v, scale=32 ** -0.5, causal=True, q_offset=0,
                                       kv_offset=40)
    dead = slice(0, 40)  # rows 0..39 sit before the first key
    assert (o2[:, :, dead] == 0).all()
    assert (lse2[:, :, dead] == torch.full_like(
        lse2[:, :, dead], float(np.log(2.0) * flash_fwd.DEFAULT_MASK_VALUE))).all()


# ---------------------------------------------------------------------------
# The C arguments on a simulated card, and the refusals.


def _recorder(name, argtypes, seen):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: seen.append((name, args)) or 0)


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: the device checks are off and a
    stand-in library with the C entries' argtypes records every call."""
    calls = []
    typed = {"fa_fwd_sm90": native.FWD_SM90_ARGTYPES, "fa_bwd_sm90": native.BWD_SM90_ARGTYPES,
             "fa_bwd_split_sm90": native.BWD_SPLIT_SM90_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(flash_bwd, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(flash_bwd_fused, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


# (options, q_offset, kv_offset, the C entries, the offsets they receive):
# unequal offsets reach both entries; equal ones and band-free ones arrive
# as (0, 0).
CARD_CASES = {
    "causal": (dict(causal=True), 1024, 0, ["fa_fwd_sm90", "fa_bwd_sm90"], (1024, 0)),
    "window": (dict(causal=True, window=(300, -1)), 512, 768, ["fa_fwd_sm90", "fa_bwd_sm90"],
               (512, 768)),
    "segment ids": (dict(causal=True, segment_ids=True), 256, 0,
                    ["fa_fwd_sm90", "fa_bwd_split_sm90"], (256, 0)),
    "equal": (dict(causal=True), 300, 300, ["fa_fwd_sm90", "fa_bwd_sm90"], (0, 0)),
    "no band": ({}, 300, 0, ["fa_fwd_sm90", "fa_bwd_sm90"], (0, 0)),
}
# Where each entry takes q_offset, kv_offset (native.*_ARGTYPES).
OFFSET_ARG = {"fa_fwd_sm90": 18, "fa_bwd_sm90": 19, "fa_bwd_split_sm90": 23}


@pytest.mark.parametrize("case", list(CARD_CASES))
def test_offsets_reach_the_c_entries(card, case):
    opts, qo, ko, entries, want = CARD_CASES[case]
    B, Hq, Hkv, N, D = 1, 4, 2, 256, 128
    q = torch.empty((B, N, Hq, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
    k, v = (torch.empty((B, N, Hkv, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
            for _ in "kv")
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    kw = dict(opts)
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = torch.zeros((B, N), dtype=torch.int32, device="meta")
    o = flashattn_tpu_torch.flash_attention(*leaves, q_offset=qo, kv_offset=ko, **kw)
    torch.autograd.grad(o, leaves, torch.empty_like(o))
    assert [name for name, _ in card] == entries
    for name, args in card:
        at = OFFSET_ARG[name]
        assert args[at:at + 2] == want, name


def test_offsets_refused_off_the_dense_route():
    """Offsets off the dense route. Quantized K/V take them (K1's quantized
    route on the card; its plain version here): int8 K/V with a causal band
    shifted by q_offset against the JAX oracle over the dequantized K/V at the
    same offset; offsets that change nothing pass too. A bias takes them (K1's bias route and its
    backward; their plain versions here): the output and the gradients,
    dbias too, against the JAX flash_attention with the same bias and
    offsets. A head dim above 128 takes them (K1's dense route's D 256 form;
    its plain version here): the output and gradients against the JAX
    flash_attention with the same offsets (its rows before the offset see no
    key: the gradients against the JAX oracle's)."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.ops.flash import flash_attention
    from flashattn_tpu.ops.oracle import attention_reference

    q, k, v = make_qkv(50, 1, 2, 64, 32)
    do = make_qkv(53, 1, 2, 64, 32)[0]
    bias = torch.from_numpy(np.random.default_rng(54).standard_normal((1, 2, 64, 64),
                                                                      dtype=np.float32))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, bias)]
    o = flashattn_tpu_torch.flash_attention(*leaves[:3], bias=leaves[3], causal=True,
                                            q_offset=48)
    got = torch.autograd.grad(o, leaves, do)
    want_o, vjp = jax.vjp(lambda a, b, c, d: flash_attention(a, b, c, bias=d, causal=True,
                                                             q_offset=48),
                          *(jnp.asarray(x.numpy()) for x in (q, k, v, bias)))
    assert_close(o.detach(), np.asarray(want_o), F32_FWD, "O with a bias")
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, vjp(jnp.asarray(do.numpy()))):
        assert_close(g, np.asarray(w), F32_BWD, f"{name} with a bias")
    flashattn_tpu_torch.flash_attention(q, k, v, bias=bias, q_offset=64)  # no band: runs
    wq, wk, wv = make_qkv(51, 1, 2, 64, 160)
    wdo = make_qkv(52, 1, 2, 64, 160)[0]
    kw = dict(causal=True)
    assert _dead_rows(wq, wk, kw, 0, 3)
    want_o = _jax_grads(wq, wk, wv, wdo, kw, 0, 3)[0]
    want_g = _jax_grads(wq, wk, wv, wdo, kw, 0, 3, fn=_jax_oracle())[1]
    leaves = [x.clone().requires_grad_(True) for x in (wq, wk, wv)]
    o = flashattn_tpu_torch.flash_attention(*leaves, kv_offset=3, **kw)
    assert_close(o.detach(), want_o, F32_FWD, "O at D 160")
    for name, got, want in zip(("dq", "dk", "dv"), torch.autograd.grad(o, leaves, wdo), want_g):
        assert_close(got, want, F32_BWD, f"{name} at D 160")
    stats = torch.full((1, 2, 64), 0.05)
    k8, v8 = (x.mul(20).round().clamp(-127, 127).to(torch.int8) for x in (k, v))
    o8 = flash_fwd.fwd(q, k8, v8, k_scale=stats, v_scale=stats, scale=0.2, causal=True,
                       q_offset=1)[0]
    want_o = attention_reference(*(jnp.asarray(x.numpy()) for x in (q, k8.float() * 0.05,
                                                                   v8.float() * 0.05)),
                                 scale=0.2, causal=True, q_offset=1)
    assert_close(o8, np.asarray(want_o), F32_FWD, "O on int8 K/V with q_offset 1")
    flash_fwd.fwd(q, k8, v8, k_scale=stats, v_scale=stats, scale=0.2, q_offset=1)  # no band
