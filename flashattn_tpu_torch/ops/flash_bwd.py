"""Two-kernel FlashAttention-2 backward: the CUDA kernels' wrappers and their plain versions.

Port of flashattn_tpu/ops/flash_bwd.py: kernels K5 (``_dkv_kernel``, dK and
dV) and K6 (``_dq_kernel``, dQ and dbias), for KV tail, GQA, causal, a sliding
window, q / kv offsets, segment ids (packed sequences), logit soft-capping
and an additive bias, in any combination. Each recomputes P
and dS from the forward's LSE and Δ (:func:`recompute_p_ds`, the JAX
``_recompute_p_ds``); on CUDA tensors one Hopper launch computes what both
compute, by route -- the device of the input decides, and a CUDA tensor
never reaches a plain version:

* without a bias, with segment ids and / or a softcap
  (:func:`split_sm90_route`): :func:`split_bwd`, the TMA + wgmma body of K3
  with both options (``csrc/flash_bwd_split_sm90.cu``; its D 256 form above
  D 128, ``csrc/bwd_sm90_wide.cuh``) in bf16, the f32 body in f32, returns dQ
  and dK / dV per *query* head;
  :func:`split_bwd_reference` is its plain version;
* with a bias (:func:`bias_bwd_route`, with or without the softcap, a
  window, q / kv offsets or segment ids, the GQA decode fold's calls too):
  :func:`bias_bwd` (``csrc/bwd_bias_sm90.cu`` in bf16 up to
  ``MAX_HEAD_DIM``, its D 256 form above D 128 on
  ``csrc/bwd_sm90_wide.cuh``; the f32 body in f32) returns dQ, dK / dV per
  *KV* head and, on request, dbias; :func:`bias_bwd_reference` is its plain
  version.

On f32 inputs the split route, the bias route and K3
(``flash_bwd_fused.bwd``) all launch one f32 body (:func:`_f32_bwd_launch`,
``csrc/flash_bwd_f32.cu``: TMA + wgmma on the three bf16 pieces of each f32
operand, ``ops/f32_split.py``, six bf16 products per f32 product; with a
bias its BIAS family, which writes dbias too), up to ``MAX_HEAD_DIM`` (its
D 256 form above D 128, a cluster of two CTAs that split D).

:func:`dkv` and :func:`dq` keep K5's and K6's plain versions
(:func:`dkv_reference` / :func:`dq_reference`: dK / dV per query head, and
on request the full f32 dbias ``[B, Hq, Nq, Nk]``) for CPU tensors; on a
CUDA tensor they raise, naming the route that takes the call.
``ops/flash.py`` reduces per-query-head dK / dV over each KV head's query
heads, dbias over the bias's broadcast dims, and casts.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops import f32_split
from flashattn_tpu_torch.ops.flash_fwd import (
    _kernel_ready,
    band_offsets,
    check_bias,
    check_segment_ids,
    check_softcap,
    check_window,
    kernel_bias,
    kernel_window,
    pair_mask,
    sm90_bias,
    sm90_segments,
)
from flashattn_tpu_torch.ops.oracle import _expand_kv, _full_f32_matmul
from flashattn_tpu_torch.utils import native

# Head dims of the CUDA backward routes: K3, the split route and the bias
# route take bf16 and f32 up to MAX_HEAD_DIM (D 136-256 in their D 256 forms,
# csrc/bwd_sm90_wide.cuh and csrc/flash_bwd_f32.cu).
MAX_HEAD_DIM = 256


def recompute_p_ds(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
                   kv_valid_len: int | None = None, segment_ids=None, window=None,
                   softcap=None, bias=None, q_offset: int = 0, kv_offset: int = 0):
    """``(P, dS, Q, K, V, dO, dL)`` in f32, K/V expanded to the query heads.

    P = exp(S·scale + bias − LSE), dL = P (dP − Δ) and dS = dL · scale,
    ``[B, Hq, Nq, Nk]``, with P = 0 exactly for pairs that the forward
    masked (:func:`pair_mask`: keys at or past ``kv_valid_len``, ``kv_pos >
    q_pos`` when ``causal``, pairs outside ``window``, in absolute positions
    ``q_offset + i`` and ``kv_offset + j``, unequal segment ids), so a dead
    row contributes nothing. ``bias`` (broadcastable to
    ``[B, Hq, Nq, Nk]``) is added to the scaled, capped logits, as the JAX
    ``_recompute_p_ds`` adds it (flash_bwd.py:97-98). With ``softcap``:
    t = tanh(S·scale / softcap), P = exp(softcap·t + bias − LSE) and dS gains
    the cap's Jacobian, dS = dL (1 − t²) scale. dL, the gradient of the
    capped logits, is the JAX kernel's dbias (flash_bwd.py:135, 300-302):
    the bias adds after the cap, so it carries neither the scale nor the
    Jacobian.
    """
    H, Nq, Nk = q.shape[1], q.shape[2], k.shape[2]
    kv_valid_len = Nk if kv_valid_len is None else kv_valid_len
    kf, vf = _expand_kv(k, v, H)
    qf, dof = q.float(), do.float()
    keep = pair_mask(Nq, Nk, kv_valid_len=kv_valid_len, causal=causal,
                     segment_ids=segment_ids, device=q.device, window=window,
                     q_offset=q_offset, kv_offset=kv_offset)
    with _full_f32_matmul():
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        jac = None
        if softcap is not None:
            t = torch.tanh(s / softcap)
            jac = 1.0 - t * t
            s = softcap * t
        if bias is not None:
            s = s + bias.float()
        p = torch.where(keep, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
        dp = torch.matmul(dof, vf.transpose(-1, -2))
    dl = p * (dp - delta.float()[..., None])
    ds = dl * scale if jac is None else dl * jac * scale
    return p, ds, qf, kf, vf, dof, dl


def dkv_reference(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
                  kv_valid_len: int | None = None, segment_ids=None, window=None,
                  softcap=None, bias=None, q_offset: int = 0, kv_offset: int = 0):
    """Plain PyTorch K5: ``(dK, dV)`` ``[B, Hq, Nk, D]`` f32, per query head:
    dV = Pᵀ dO, dK = dSᵀ Q (:func:`recompute_p_ds`)."""
    p, ds, qf, _, _, dof, _ = recompute_p_ds(
        q, k, v, do, lse, delta, scale=scale, causal=causal, kv_valid_len=kv_valid_len,
        segment_ids=segment_ids, window=window, softcap=softcap, bias=bias, q_offset=q_offset,
        kv_offset=kv_offset)
    with _full_f32_matmul():
        return torch.matmul(ds.transpose(-1, -2), qf), torch.matmul(p.transpose(-1, -2), dof)


def dq_reference(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
                 kv_valid_len: int | None = None, segment_ids=None, window=None, softcap=None,
                 bias=None, want_dbias: bool = False, q_offset: int = 0, kv_offset: int = 0):
    """Plain PyTorch K6: dQ = dS K, ``[B, Hq, Nq, D]`` f32; with
    ``want_dbias``, ``(dQ, dbias)`` where dbias = P (dP − Δ) is the full f32
    ``[B, Hq, Nq, Nk]``, 0 on masked pairs (:func:`recompute_p_ds`)."""
    _, ds, _, kf, _, _, dl = recompute_p_ds(
        q, k, v, do, lse, delta, scale=scale, causal=causal, kv_valid_len=kv_valid_len,
        segment_ids=segment_ids, window=window, softcap=softcap, bias=bias, q_offset=q_offset,
        kv_offset=kv_offset)
    with _full_f32_matmul():
        dq_ = torch.matmul(ds, kf)
    return (dq_, dl) if want_dbias else dq_


def check_args(q, k, v, do, lse, delta, kv_valid_len, segment_ids=None) -> int:
    """Validate a backward call's arguments (shared by K3, K5 and K6); returns
    ``kv_valid_len`` with None resolved to Nk."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or do.shape != q.shape:
        raise ValueError(f"q/k/v/do must be rank-4 with do like q, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(do.shape)}")
    B, Hq, Nq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} incompatible with q {tuple(q.shape)}")
    if Hq % k.shape[1] != 0:
        raise ValueError(f"GQA requires Hkv | Hq: Hq={Hq}, Hkv={k.shape[1]}")
    if lse.shape != (B, Hq, Nq) or delta.shape != (B, Hq, Nq):
        raise ValueError(f"lse {tuple(lse.shape)} / delta {tuple(delta.shape)} must be {(B, Hq, Nq)}")
    if len({x.dtype for x in (q, k, v, do)}) != 1:
        raise ValueError(f"q/k/v/do dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    if len({x.device for x in (q, k, v, do, lse, delta)}) != 1:
        raise ValueError("q/k/v/do/lse/delta must be on one device")
    Nk = k.shape[2]
    kv_valid_len = Nk if kv_valid_len is None else int(kv_valid_len)
    if not 0 <= kv_valid_len <= Nk:
        raise ValueError(f"kv_valid_len={kv_valid_len} outside [0, {Nk}]")
    check_segment_ids(segment_ids, B, Nq, Nk, q.device)
    return kv_valid_len


def check_kernel_args(q, name: str) -> None:
    """Raise for a call that no CUDA backward kernel (K3, K5, K6) takes: a
    tensor off the card, then :func:`check_kernel_dims`."""
    if q.device.type != "cuda":
        raise NotImplementedError(f"no {name} kernel for device {q.device}")
    check_kernel_dims(q, name)


def check_kernel_dims(q, name: str) -> None:
    """Raise for what the CUDA backward kernels do not take, whatever the
    device: a dtype other than bf16 and f32, D not a multiple of 8 or above
    ``MAX_HEAD_DIM`` (in either dtype, with or without a bias), a grid past
    the CUDA limits."""
    B, Hq, _, D = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the CUDA {name} takes bfloat16 or float32, got {q.dtype}")
    if D % 8 or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA {name} takes head dims that are multiples of 8 up to {MAX_HEAD_DIM}, "
            f"got D={D} (ROADMAP queue 2, K1 options: head dims above 256)")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must each be at most 65535 (CUDA grid limit)")


def _split_kwargs(q, k, v, do, lse, delta, *, scale, causal, kv_valid_len, segment_ids,
                  window, softcap, bias, q_offset, kv_offset) -> dict:
    """Validate a :func:`dkv` / :func:`dq` call and return the keyword
    arguments of its kernel or plain version, ``kv_valid_len`` resolved."""
    kv_valid_len = check_args(q, k, v, do, lse, delta, kv_valid_len, segment_ids)
    check_bias(bias, q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.device)
    window = check_window(window)
    q_offset, kv_offset = band_offsets(causal, window, q_offset, kv_offset)
    return dict(scale=scale, causal=causal, kv_valid_len=kv_valid_len, segment_ids=segment_ids,
                window=window, softcap=check_softcap(softcap), bias=bias, q_offset=q_offset,
                kv_offset=kv_offset)


def _no_split_kernel(q, name: str, *, bias) -> None:
    """Raise for a CUDA call of :func:`dkv` / :func:`dq`: one Hopper launch
    computes K5 and K6 together, :func:`bias_bwd` with a bias and
    :func:`split_bwd` (or K3) without."""
    check_kernel_args(q, name)
    route = ("flash_bwd.bias_bwd (bias_bwd_route)" if bias is not None else
             "flash_bwd.split_bwd (split_sm90_route: segment ids or a softcap; K3 otherwise)")
    raise NotImplementedError(
        f"the CUDA {name} runs with K5 and K6 as one Hopper launch: {route}")


def dkv(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
        kv_valid_len: int | None = None, segment_ids=None, window=None, softcap=None,
        bias=None, q_offset: int = 0, kv_offset: int = 0):
    """K5: ``(dK, dV)`` ``[B, Hq, Nk, D]`` in f32, per query head.

    ``q``/``do`` ``[B,Hq,Nq,D]``, ``k``/``v`` ``[B,Hkv,Nk,D]`` in one dtype;
    ``lse`` (natural log, from the forward) and ``delta`` = rowsum(dO·O),
    ``[B,Hq,Nq]`` f32; ``segment_ids``, ``window``, ``softcap``, ``bias``
    (``[B|1, Hq|1, Nq|1, Nk]``) and the offsets as in ``flash_fwd.fwd``. CPU tensors take
    :func:`dkv_reference`. CUDA tensors raise: K5 runs with K6 in one launch,
    :func:`bias_bwd` with a bias, :func:`split_bwd` (or K3) without.
    """
    kw = _split_kwargs(q, k, v, do, lse, delta, scale=scale, causal=causal,
                       kv_valid_len=kv_valid_len, segment_ids=segment_ids, window=window,
                       softcap=softcap, bias=bias, q_offset=q_offset, kv_offset=kv_offset)
    if q.device.type == "cpu":
        return dkv_reference(q, k, v, do, lse, delta, **kw)
    _no_split_kernel(q, "K5", bias=bias)


def dq(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
       kv_valid_len: int | None = None, segment_ids=None, window=None, softcap=None,
       bias=None, want_dbias: bool = False, q_offset: int = 0, kv_offset: int = 0):
    """K6: dQ ``[B, Hq, Nq, D]`` in f32; with ``want_dbias`` (which needs
    ``bias``), ``(dQ, dbias)``, dbias the full f32 ``[B, Hq, Nq, Nk]``
    gradient of the bias, P (dP − Δ).

    Arguments as :func:`dkv`. CPU tensors take :func:`dq_reference`; CUDA
    tensors raise, as :func:`dkv`.
    """
    if want_dbias and bias is None:
        raise ValueError("want_dbias needs a bias")
    kw = _split_kwargs(q, k, v, do, lse, delta, scale=scale, causal=causal,
                       kv_valid_len=kv_valid_len, segment_ids=segment_ids, window=window,
                       softcap=softcap, bias=bias, q_offset=q_offset, kv_offset=kv_offset)
    if q.device.type == "cpu":
        return dq_reference(q, k, v, do, lse, delta, want_dbias=want_dbias, **kw)
    _no_split_kernel(q, "K6", bias=bias)


def bias_bwd_route(*, head_dim: int, bias, dtype) -> bool:
    """Whether a backward goes to :func:`bias_bwd`, K5 and K6 in one launch:
    every call with a bias in bf16 at a head dim up to ``MAX_HEAD_DIM``
    (the Hopper bias kernel, ``csrc/bwd_bias_sm90.cu``, its D 256 form above
    D 128) or in f32 (the f32 body's BIAS family, ``csrc/flash_bwd_f32.cu``,
    its D 256 form above D 128), each a multiple of 8, as every CUDA
    backward's -- causal or not, with or without a window, q / kv offsets,
    segment ids or the softcap, the GQA decode fold's calls too, whichever K1
    route the forward took. :func:`bias_bwd` decides the device: a CPU
    tensor takes the plain version."""
    return (bias is not None and dtype in (torch.bfloat16, torch.float32)
            and head_dim <= MAX_HEAD_DIM)


def bias_bwd_reference(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
                       kv_valid_len: int | None = None, bias, softcap=None,
                       want_dbias: bool = False, segment_ids=None, window=None,
                       q_offset: int = 0, kv_offset: int = 0):
    """Plain PyTorch K5 + K6 over one :func:`recompute_p_ds`: ``(dQ, dK, dV,
    dbias)``, f32, dQ ``[B, Hq, Nq, D]``, dK / dV ``[B, Hkv, Nk, D]`` summed
    over each KV head's query heads (as the kernel writes them), dbias the
    full ``[B, Hq, Nq, Nk]`` P (dP − Δ) with ``want_dbias``, else None, 0 on
    every pair the masks drop (the KV tail, the band of ``causal``,
    ``window`` and the offsets, unequal ``segment_ids``). With ``softcap``
    dS carries the cap's Jacobian and dbias does not (the gradient of the
    capped logit)."""
    p, ds, qf, kf, _, dof, dl = recompute_p_ds(
        q, k, v, do, lse, delta, scale=scale, causal=causal, kv_valid_len=kv_valid_len,
        bias=bias, softcap=softcap, segment_ids=segment_ids, window=window, q_offset=q_offset,
        kv_offset=kv_offset)
    B, Hq, _, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    with _full_f32_matmul():
        dq_ = torch.matmul(ds, kf)
        dk = torch.matmul(ds.transpose(-1, -2), qf).view(B, Hkv, Hq // Hkv, Nk, D).sum(2)
        dv = torch.matmul(p.transpose(-1, -2), dof).view(B, Hkv, Hq // Hkv, Nk, D).sum(2)
    return dq_, dk, dv, (dl if want_dbias else None)


# The tiles of the Hopper backward body (csrc/bwd_sm90_tile.cuh: K3, the bias
# and split routes): its Q tile (the LSE / Δ rows and, with segment ids, the
# query ids it bulk-copies, padded to a multiple) and its KV tile (the keys
# of one CTA, the tiles of the key ids' ranges).
SM90_BWD_Q_TILE = 64
SM90_BWD_KV_TILE = 128
# The head dims above which K3's and the split route's C entries launch their
# D 256 form (csrc/bwd_sm90_wide.cuh: 64 keys a CTA; it reads the 128-key
# tiles' id ranges all the same).
SM90_BWD_NARROW_MAX = 128


def _launch_bias_bwd(lib, q, k, v, do, lse, delta, bias, bias_strides, dq_, dk, dv, dbias,
                     seg=None, *, scale, causal, kv_valid_len, nq_pad, softcap, stream,
                     window=None, q_offset: int = 0, kv_offset: int = 0) -> int:
    """Call ``lib.fa_bwd_bias_sm90`` with the arguments of one launch (the C
    entry's order, ``native.BWD_BIAS_SM90_ARGTYPES``), ``seg`` being
    ``flash_fwd.sm90_segments``' tensors at the kernel's tiles or None;
    returns its cudaError_t."""
    B, Hq, Nq, D = q.shape
    seg_ptrs = (None,) * 4 if seg is None else tuple(x.data_ptr() for x in seg)
    return lib.fa_bwd_bias_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), bias.data_ptr(), dq_.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if dbias is None else dbias.data_ptr(), *seg_ptrs, B, Hq, k.shape[1], Nq,
        k.shape[2], D, kv_valid_len, int(bool(causal)), *kernel_window(window), q_offset,
        kv_offset, nq_pad, float(scale), softcap or 0.0, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *do.stride()[:3], *bias_strides, stream)


def _padded_rows(x, nq_pad: int):
    """``x`` [B, Hq, Nq] as f32 with rows of ``nq_pad`` (zeros past Nq), the
    kernel's LSE / Δ layout; ``x`` itself when already so."""
    x = x.float().contiguous()
    if x.shape[-1] == nq_pad:
        return x
    out = x.new_zeros((*x.shape[:-1], nq_pad))
    out[..., :x.shape[-1]] = x
    return out


def bias_bwd(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
             kv_valid_len: int | None = None, bias, softcap=None, want_dbias: bool = False,
             segment_ids=None, window=None, q_offset: int = 0, kv_offset: int = 0):
    """K5 + K6 with a bias in one launch: ``(dQ, dK, dV, dbias)`` in f32, dQ
    ``[B, Hq, Nq, D]``, dK / dV ``[B, Hkv, Nk, D]`` per KV head (summed over
    its query heads), dbias the full ``[B, Hq, Nq, Nk]`` with ``want_dbias``,
    else None, exactly 0 on every pair the masks drop.

    Arguments as :func:`dkv`, ``bias`` ``[B|1, Hq|1, Nq|1, Nk]`` required,
    ``softcap`` the forward's cap or None, the window, the offsets and the
    segment ids as the forward took them. CPU tensors take
    :func:`bias_bwd_reference`. CUDA tensors launch the Hopper kernel, which
    takes what :func:`bias_bwd_route` sends it (bf16, ``D % 8 == 0``, ``D <=
    MAX_HEAD_DIM``; above ``SM90_BWD_NARROW_MAX`` its D 256 form, whose dK /
    dV come per query head), or on f32 up to ``MAX_HEAD_DIM`` the f32 body
    (:func:`_f32_bwd_launch`, dK / dV per query head too); each KV
    head's group of per-query-head dK / dV is summed here; anything else
    raises. dQ is summed over the KV tiles by the card's L2 (one bulk
    reduction per tile), so its last bits may differ from run to run.
    ``bias_bwd.launches`` counts launches on either kernel,
    ``bias_bwd.launches_dbias`` those that wrote dbias,
    ``bias_bwd.launches_f32`` those of the f32 body,
    ``bias_bwd.launches_d256`` those of the bf16 kernel's D 256 form.
    """
    kv_valid_len = check_args(q, k, v, do, lse, delta, kv_valid_len, segment_ids)
    if bias is None:
        raise ValueError("bias_bwd needs a bias")
    B, Hq, Nq, D = q.shape
    window = check_window(window)
    q_offset, kv_offset = band_offsets(causal, window, q_offset, kv_offset)
    Hkv, Nk = k.shape[1], k.shape[2]
    check_bias(bias, B, Hq, Nq, Nk, q.device)
    softcap = check_softcap(softcap)
    kw = dict(scale=scale, causal=causal, kv_valid_len=kv_valid_len, bias=bias, softcap=softcap,
              segment_ids=segment_ids, window=window, q_offset=q_offset, kv_offset=kv_offset)
    if q.device.type == "cpu":
        return bias_bwd_reference(q, k, v, do, lse, delta, want_dbias=want_dbias, **kw)
    check_kernel_args(q, "K5 + K6 bias route")
    f32 = dict(dtype=torch.float32, device=q.device)
    dbias = None
    if want_dbias:
        # The kernel writes the tiles it visits; the band (causal, a window),
        # the segment ids and the KV tail leave others (dbias_skips).
        skipped = dbias_skips(causal=causal, window=window, segment_ids=segment_ids,
                              kv_valid_len=kv_valid_len, nk=Nk)
        dbias = (torch.zeros if skipped else torch.empty)((B, Hq, Nq, Nk), **f32)
    if q.dtype == torch.float32:
        before = _f32_bwd_launch.launches
        dq_, dk, dv = _f32_bwd_launch(q, k, v, do, lse, delta, dbias=dbias, **kw)
        launched = _f32_bwd_launch.launches - before  # 0 without a key or a row
        bias_bwd.launches += launched
        bias_bwd.launches_f32 += launched
        bias_bwd.launches_dbias += launched * int(want_dbias)
        return dq_, _per_kv_head(dk, Hkv), _per_kv_head(dv, Hkv), dbias
    wide = D > SM90_BWD_NARROW_MAX  # the D 256 form: dK / dV per query head
    dq_ = torch.zeros((B, Hq, Nq, D), **f32)
    dk = torch.empty((B, Hq if wide else Hkv, Nk, D), **f32)
    dv = torch.empty_like(dk)
    if Nq == 0 or Nk == 0 or B == 0 or Hq == 0:  # an empty grid is not a valid launch
        dk, dv = (torch.zeros((B, Hkv, Nk, D), **f32) for _ in range(2))
        return dq_, dk, dv, None if dbias is None else dbias.zero_()
    q, k, v, do = (_kernel_ready(x, tma=True) for x in (q, k, v, do))
    nq_pad = -(-Nq // SM90_BWD_Q_TILE) * SM90_BWD_Q_TILE
    lse, delta = _padded_rows(lse, nq_pad), _padded_rows(delta, nq_pad)
    bias, bias_strides = sm90_bias(bias)
    seg = sm90_segments(segment_ids, Nq, kv_valid_len, q_tile=SM90_BWD_Q_TILE,
                        kv_tile=SM90_BWD_KV_TILE, pad_q=True)
    with torch.cuda.device(q.device):
        rc = _launch_bias_bwd(native.kernels(), q, k, v, do, lse, delta, bias, bias_strides,
                              dq_, dk, dv, dbias, seg, scale=scale, causal=causal,
                              kv_valid_len=kv_valid_len, nq_pad=nq_pad, softcap=softcap,
                              stream=torch.cuda.current_stream(q.device).cuda_stream,
                              window=window, q_offset=q_offset, kv_offset=kv_offset)
    native.check(rc, "bwd_bias_sm90 kernel launch")
    bias_bwd.launches += 1
    bias_bwd.launches_dbias += int(want_dbias)
    bias_bwd.launches_d256 += int(wide)
    return dq_, _per_kv_head(dk, Hkv), _per_kv_head(dv, Hkv), dbias


bias_bwd.launches = 0
bias_bwd.launches_dbias = 0
bias_bwd.launches_f32 = 0
bias_bwd.launches_d256 = 0


def _per_kv_head(x, Hkv: int):
    """dK or dV ``[B, H, Nk, D]`` summed over each KV head's group of query
    heads when it comes per query head (H > Hkv), else itself."""
    B, H, Nk, D = x.shape
    return x if H == Hkv else x.view(B, Hkv, H // Hkv, Nk, D).sum(2)


def dbias_skips(*, causal: bool, window, segment_ids, kv_valid_len: int, nk: int) -> bool:
    """Whether the bias route's kernel may leave (Q tile, KV tile) pairs of
    dbias unwritten, so that :func:`bias_bwd` must zero it first: the pairs
    that the band (causal, a window) or the segment ids skip, and the keys
    from ``kv_valid_len`` on. Offsets only shift a band, so they add none."""
    return (causal or kernel_window(window) != (-1, -1) or segment_ids is not None
            or kv_valid_len < nk)  # bias bwd dbias zero fill


# The most Q tiles a CTA of the split route lists (csrc/bwd_sm90_tile.cuh,
# BB_SEG_LIST).
SPLIT_MAX_Q_TILES = 4096


def split_sm90_route(*, head_dim: int, bias, dtype, segment_ids, softcap) -> bool:
    """Whether a backward that K3 does not take (segment ids, a softcap or a
    bias) goes to the one launch of :func:`split_bwd` in place of K5 then
    K6: bf16 (the Hopper kernel) or f32 (the f32 body), each with its D 256
    form above D 128, at a head dim up to ``MAX_HEAD_DIM`` (a multiple of 8,
    as every CUDA backward's), no bias, and segment ids or a
    softcap -- with or without causal, a window, offsets, GQA or a tail. The
    calls with a bias take :func:`bias_bwd`.
    :func:`split_bwd` decides the device: a CPU tensor takes the plain
    version."""
    return (bias is None and dtype in (torch.bfloat16, torch.float32)
            and head_dim <= MAX_HEAD_DIM and (segment_ids is not None or softcap is not None))


def split_bwd_reference(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
                        kv_valid_len: int | None = None, segment_ids=None, window=None,
                        softcap=None, q_offset: int = 0, kv_offset: int = 0):
    """Plain PyTorch K5 + K6 without a bias over one :func:`recompute_p_ds`:
    ``(dQ [B, Hq, Nq, D], dK, dV [B, Hq, Nk, D])``, f32, dK / dV per query
    head (as the kernel writes them): dQ = dS K, dK = dSᵀ Q, dV = Pᵀ dO."""
    p, ds, qf, kf, _, dof, _ = recompute_p_ds(
        q, k, v, do, lse, delta, scale=scale, causal=causal, kv_valid_len=kv_valid_len,
        segment_ids=segment_ids, window=window, softcap=softcap, q_offset=q_offset,
        kv_offset=kv_offset)
    with _full_f32_matmul():
        return (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf),
                torch.matmul(p.transpose(-1, -2), dof))


def _launch_split(lib, q, k, v, do, lse, delta, dq_, dk, dv, seg, *, scale, causal,
                  kv_valid_len, window, softcap, nq_pad, stream, q_offset: int = 0,
                  kv_offset: int = 0, pieces: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None, dbias: torch.Tensor | None = None,
                  bias_strides: tuple[int, int, int] = (0, 0, 0)) -> int:
    """Call ``lib.fa_bwd_split_sm90`` -- or, given ``pieces`` (the bf16
    scratch of ``f32_split.scratch``), ``lib.fa_bwd_f32``, whose arguments
    are the same with ``pieces`` after dv and the f32 ``bias``, ``dbias``
    (each a tensor or None) and ``bias_strides`` before the stream -- with
    the arguments of one launch (the C entry's order,
    ``native.BWD_SPLIT_SM90_ARGTYPES`` / ``BWD_F32_ARGTYPES``), ``seg`` being
    ``flash_fwd.sm90_segments``' tensors at the kernel's tiles or None;
    returns its cudaError_t."""
    B, Hq, Nq, D = q.shape
    seg_ptrs = (None,) * 4 if seg is None else tuple(x.data_ptr() for x in seg)
    if pieces is None:
        entry, scratch, tail = lib.fa_bwd_split_sm90, (), ()
    else:
        entry, scratch = lib.fa_bwd_f32, (pieces.data_ptr(),)
        tail = (*(None if x is None else x.data_ptr() for x in (bias, dbias)), *bias_strides)
    return entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq_.data_ptr(), dk.data_ptr(), dv.data_ptr(), *scratch, *seg_ptrs,
        B, Hq, k.shape[1], Nq, k.shape[2], D, kv_valid_len, int(bool(causal)),
        *kernel_window(window), q_offset, kv_offset, nq_pad, float(scale), softcap or 0.0,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], *tail, stream)


def split_bwd(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
              kv_valid_len: int | None = None, segment_ids=None, window=None, softcap=None,
              q_offset: int = 0, kv_offset: int = 0):
    """K5 + K6 without a bias in one launch: ``(dQ [B, Hq, Nq, D], dK, dV
    [B, Hq, Nk, D])`` in f32, dK / dV per query head.

    Arguments as :func:`dkv` without ``bias`` (the offsets too: the band
    shifted by ``q_offset - kv_offset``, a KV tile that no row reaches
    writing zero dK / dV); ``segment_ids`` or ``softcap`` (or both) required -- the call with neither is K3's
    (``flash_bwd_fused.bwd``). CPU tensors take :func:`split_bwd_reference`.
    CUDA tensors launch the Hopper kernel, which takes bf16 with ``D % 8 ==
    0``, ``D <= 256`` (its D 256 form above 128) and, with segment ids, ``Nq
    <= 64 · SPLIT_MAX_Q_TILES``, or, on f32 at the same head dims, the f32
    body (:func:`_f32_bwd_launch`); anything else raises. dQ is
    summed over the KV tiles by the card's L2 (one bulk reduction per tile),
    so its last bits may differ from run to run.
    ``split_bwd.launches`` counts the route's launches, on either kernel,
    ``split_bwd.launches_d256`` those of its D 256 form (bf16 above D 128).
    """
    kv_valid_len = check_args(q, k, v, do, lse, delta, kv_valid_len, segment_ids)
    window, softcap = check_window(window), check_softcap(softcap)
    if segment_ids is None and softcap is None:
        raise ValueError("split_bwd takes segment ids or a softcap (without either: "
                         "flash_bwd_fused.bwd, K3)")
    q_offset, kv_offset = band_offsets(causal, window, q_offset, kv_offset)
    kw = dict(scale=scale, causal=causal, kv_valid_len=kv_valid_len, segment_ids=segment_ids,
              window=window, softcap=softcap, q_offset=q_offset, kv_offset=kv_offset)
    if q.device.type == "cpu":
        return split_bwd_reference(q, k, v, do, lse, delta, **kw)
    check_kernel_args(q, "K5 + K6 split route")
    if q.dtype == torch.float32:
        out = _f32_bwd_launch(q, k, v, do, lse, delta, **kw)
        split_bwd.launches += 1
        return out
    B, Hq, Nq, D = q.shape
    Nk = k.shape[2]
    if segment_ids is not None and -(-Nq // SM90_BWD_Q_TILE) > SPLIT_MAX_Q_TILES:
        raise ValueError(f"Nq={Nq} with segment ids: the split route's kernel visits at most "
                         f"{SPLIT_MAX_Q_TILES} Q tiles of {SM90_BWD_Q_TILE} rows")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_ = torch.zeros((B, Hq, Nq, D), **f32)  # added to by one bulk reduction a tile
    dk = torch.empty((B, Hq, Nk, D), **f32)
    dv = torch.empty((B, Hq, Nk, D), **f32)
    if Nq == 0 or Nk == 0 or B == 0 or Hq == 0 or kv_valid_len == 0:
        return dq_, dk.zero_(), dv.zero_()  # no key attends: an empty grid is not a valid launch
    q, k, v, do = (_kernel_ready(x, tma=True) for x in (q, k, v, do))
    nq_pad = -(-Nq // SM90_BWD_Q_TILE) * SM90_BWD_Q_TILE
    lse, delta = _padded_rows(lse, nq_pad), _padded_rows(delta, nq_pad)
    seg = sm90_segments(segment_ids, Nq, kv_valid_len, q_tile=SM90_BWD_Q_TILE,
                        kv_tile=SM90_BWD_KV_TILE, pad_q=True)
    with torch.cuda.device(q.device):
        rc = _launch_split(native.kernels(), q, k, v, do, lse, delta, dq_, dk, dv, seg,
                           scale=scale, causal=causal, kv_valid_len=kv_valid_len, window=window,
                           softcap=softcap, nq_pad=nq_pad,
                           stream=torch.cuda.current_stream(q.device).cuda_stream,
                           q_offset=q_offset, kv_offset=kv_offset)
    native.check(rc, "flash_bwd_split_sm90 kernel launch")
    split_bwd.launches += 1
    split_bwd.launches_d256 += int(D > SM90_BWD_NARROW_MAX)
    return dq_, dk, dv


split_bwd.launches = 0
split_bwd.launches_d256 = 0


# The f32 body's Q tile (query rows per step, the LSE / Delta rows and, with
# segment ids, the query ids it copies, padded to a multiple) and KV tile (the
# keys of one CTA): csrc/flash_bwd_f32.cu.
F32_BWD_Q_TILE = 32
F32_BWD_KV_TILE = 64


def _f32_bwd_launch(q, k, v, do, lse, delta, *, scale: float, causal: bool,
                    kv_valid_len: int, segment_ids, window, softcap, q_offset: int,
                    kv_offset: int, bias=None, dbias: torch.Tensor | None = None):
    """Launch the f32 backward body's C entry (``csrc/flash_bwd_f32.cu``: the
    split of q, k, v and do into their bf16 pieces, then the kernel -- K3
    without segment ids, a softcap or a bias, K5 + K6 with any of them) on
    the CUDA f32 call that :func:`split_bwd`, :func:`bias_bwd` or
    ``flash_bwd_fused.bwd`` has checked and normalised (the forward's pieces
    are not kept): ``(dQ [B, Hq, Nq, D], dK, dV [B, Hq, Nk, D])`` in f32, dK /
    dV per query head. With a ``bias`` (read in f32 with
    ``flash_fwd.kernel_bias``' strides) it runs the BIAS family, and writes
    dbias into ``dbias`` (``[B, Hq, Nq, Nk]`` f32, allocated by the caller,
    zeroed where :func:`dbias_skips` says; None: no dbias). dQ is added to by
    one bulk reduction a tile, so its last bits may differ from run to run.
    Above D 128 the C entry launches the D 256 form. ``_f32_bwd_launch.launches``
    counts the kernel's launches, ``_f32_bwd_launch.launches_d256`` those of
    its D 256 form (whichever of K3, the split route and the bias route
    called it), ``_f32_bwd_launch.launches_split`` the split's."""
    B, Hq, Nq, D = q.shape
    Nk = k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_ = torch.zeros((B, Hq, Nq, D), **f32)  # added to by one bulk reduction a tile
    dk = torch.empty((B, Hq, Nk, D), **f32)
    dv = torch.empty((B, Hq, Nk, D), **f32)
    if Nq == 0 or Nk == 0 or B == 0 or Hq == 0 or kv_valid_len == 0:
        if dbias is not None:
            dbias.zero_()
        return dq_, dk.zero_(), dv.zero_()  # no key attends: an empty grid is not a valid launch
    q, k, v, do = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v, do))
    bias, bias_strides = kernel_bias(bias)
    pieces = f32_split.scratch(2 * B * Hq * Nq, B * k.shape[1] * kv_valid_len, D, q.device)
    nq_pad = -(-Nq // F32_BWD_Q_TILE) * F32_BWD_Q_TILE
    lse, delta = _padded_rows(lse, nq_pad), _padded_rows(delta, nq_pad)
    seg = sm90_segments(segment_ids, Nq, kv_valid_len, q_tile=F32_BWD_Q_TILE,
                        kv_tile=F32_BWD_KV_TILE, pad_q=True)
    with torch.cuda.device(q.device):
        rc = _launch_split(native.kernels(), q, k, v, do, lse, delta, dq_, dk, dv, seg,
                           scale=scale, causal=causal, kv_valid_len=kv_valid_len, window=window,
                           softcap=softcap, nq_pad=nq_pad,
                           stream=torch.cuda.current_stream(q.device).cuda_stream,
                           q_offset=q_offset, kv_offset=kv_offset, pieces=pieces, bias=bias,
                           dbias=dbias, bias_strides=bias_strides)
    native.check(rc, "flash_bwd_f32 kernel launch")
    _f32_bwd_launch.launches += 1
    _f32_bwd_launch.launches_d256 += int(D > SM90_BWD_NARROW_MAX)
    _f32_bwd_launch.launches_split += 1
    return dq_, dk, dv


_f32_bwd_launch.launches = 0
_f32_bwd_launch.launches_d256 = 0
_f32_bwd_launch.launches_split = 0
