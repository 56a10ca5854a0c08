"""Quantized-KV attention: int8 / fp8 K/V with in-kernel dequantization.

Port of flashattn_tpu/ops/quant.py. The KV cache is stored as int8 or
float8_e4m3fn with one f32 scale per token per head; K1 (ops/flash_fwd.py)
widens the payload to bf16 in shared memory and applies the scales to the
score and probability columns, so K/V device-memory traffic is half of bf16's
for bandwidth-bound decode.

:func:`quantize_kv` is plain PyTorch, as the JAX function is plain ``jnp``
outside any kernel, with the same rounding: ``torch.round`` and
``jnp.round`` both round half to even, and the fp8 cast rounds to nearest.
Forward only: gradients through a quantized cache are not defined; train
with :func:`flashattn_tpu_torch.ops.flash.flash_attention`.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from flashattn_tpu_torch.ops import flash_fwd
from flashattn_tpu_torch.ops.flash import _dispatch_dtype
from flashattn_tpu_torch.utils import platform


class QuantizedKV(NamedTuple):
    k_q: torch.Tensor      # [B, Hkv, Nk, D] int8 or float8_e4m3fn
    k_scale: torch.Tensor  # [B, Hkv, Nk] f32
    v_q: torch.Tensor      # [B, Hkv, Nk, D]
    v_scale: torch.Tensor  # [B, Hkv, Nk] f32


def _qmax(dtype) -> float:
    if dtype == torch.int8:
        return 127.0
    if dtype == torch.float8_e4m3fn:
        return 448.0
    raise ValueError(f"unsupported KV quant dtype {dtype}")


def resolve_quant_dtype(dtype, *, allow_slow_fp8: bool = False, device=None):
    """The JAX package's guard against the fp8 performance trap: on a device
    without native fp8 matrix units (:func:`platform.native_fp8_matmul`: the
    CPU; an H100 has them) an fp8 request warns and falls back to int8 (same
    memory footprint) unless ``allow_slow_fp8`` is set. ``device`` is the
    device the cache lives on (None: the current CUDA device, else the CPU)."""
    if (dtype == torch.float8_e4m3fn and not allow_slow_fp8
            and not platform.native_fp8_matmul(device)):
        warnings.warn(
            "fp8 KV quantization requested but this accelerator has no "
            "native fp8 matmul (software conversion measured 5-7x slower "
            "than int8 on TPU v5e); falling back to int8. Pass "
            "allow_slow_fp8=True to force fp8.",
            stacklevel=3,
        )
        return torch.int8
    return dtype


def quantize_kv(k: torch.Tensor, v: torch.Tensor, dtype=torch.int8, *,
                allow_slow_fp8: bool = False) -> QuantizedKV:
    """Per-token symmetric quantization of K and V over their last dim:
    ``scale = max(amax, 1e-8) / qmax``, int8 ``clip(round(x / scale), ±127)``
    or fp8 ``(x / scale)`` cast to e4m3 (the fp8 guard decides on k's
    device)."""
    dtype = resolve_quant_dtype(dtype, allow_slow_fp8=allow_slow_fp8, device=k.device)
    qmax = _qmax(dtype)

    def quant(x):
        xf = x.float()
        scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / qmax
        scaled = xf / scale[..., None]
        if dtype == torch.int8:
            q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
        else:
            q = scaled.to(dtype)
        return q, scale

    k_q, k_s = quant(k)
    v_q, v_s = quant(v)
    return QuantizedKV(k_q, k_s, v_q, v_s)


def dequantize_kv(qkv: QuantizedKV, dtype=torch.bfloat16):
    k = qkv.k_q.float() * qkv.k_scale[..., None]
    v = qkv.v_q.float() * qkv.v_scale[..., None]
    return k.to(dtype), v.to(dtype)


def flash_attention_quantized(
    q: torch.Tensor,
    qkv: QuantizedKV,
    *,
    bias: torch.Tensor | None = None,
    causal: bool = False,
    scale: float | None = None,
    layout: str = "BHND",
) -> torch.Tensor:
    """Fused attention over a quantized KV cache (forward only).

    ``q``: full-precision queries; ``qkv``: from :func:`quantize_kv`, with
    scales ``[B, Hkv, Nk]`` (``[B, Nk, Hkv]`` in the BNHD layout, read
    through their strides without a copy). ``bias``: additive logits bias
    broadcastable to ``[B, H, Nq, Nk]`` (e.g. the JAX decode step's
    not-yet-written cache-slot mask). On a CUDA tensor K1 dequantizes inside the kernel; on
    the CPU its plain version attends over the dequantized cache in f32.
    """
    in_dtype = q.dtype
    if layout == "BNHD":
        q = q.transpose(1, 2)
        qkv = QuantizedKV(*(x.transpose(1, 2) for x in qkv))
    elif layout != "BHND":
        raise ValueError(f"unknown layout {layout!r}")

    B, Hq, Nq, D = q.shape
    _, Hkv, Nk, _ = qkv.k_q.shape
    if scale is None:
        scale = float(D) ** -0.5
    q = q.to(_dispatch_dtype(in_dtype))

    # GQA decode fold (same as flash_attention): tiny-Nq non-causal queries
    # against a GQA cache fold rep q-heads into the Q-tile rows so each
    # quantized KV tile is read once instead of rep times. Head-broadcast
    # biases (a [1, 1, 1, Nk] key mask) are fold-safe.
    rep_fold = Hq // Hkv
    if bias is not None:
        while bias.ndim < 4:
            bias = bias[None]
    if rep_fold > 1 and not causal and Nq * rep_fold <= 32:
        if bias is None or bias.shape[1] == 1:
            bf = bias
            if bf is not None and bf.shape[2] > 1:
                bf = bf.repeat(1, 1, rep_fold, 1)
            of = flash_attention_quantized(
                q.reshape(B, Hkv, rep_fold * Nq, D).to(in_dtype), qkv, bias=bf, scale=scale)
            of = of.reshape(B, Hq, Nq, D)
            return of.transpose(1, 2) if layout == "BNHD" else of

    if bias is not None:
        bias = bias.expand(*bias.shape[:3], Nk)
    o, _ = flash_fwd.fwd(q, qkv.k_q, qkv.v_q, scale=float(scale), causal=bool(causal),
                         bias=bias, k_scale=qkv.k_scale, v_scale=qkv.v_scale)
    o = o.to(in_dtype)
    return o.transpose(1, 2) if layout == "BNHD" else o
