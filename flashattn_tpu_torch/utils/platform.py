"""What the device offers (port of flashattn_tpu/utils/platform.py, the part the
port needs: ``native_fp8_matmul``)."""

from __future__ import annotations

import torch


def native_fp8_matmul(device=None) -> bool:
    """Whether ``device`` multiplies fp8 natively: a CUDA device of compute
    capability (8, 9) or later (Ada, Hopper). The CPU has no fp8 matrix unit,
    as the JAX package reports for its CPU backend, so fp8 KV quantization
    falls back to int8 there unless forced (ops/quant.py). ``device`` None
    means the current CUDA device when there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return False
    return torch.cuda.get_device_capability(device) >= (8, 9)
