"""The attention FLOP model (port of flashattn_tpu/utils/timing.py::attention_flops).

Every TFLOP/s figure of the port is computed with it, as the JAX package's
are; the timing loops themselves are CUDA-event code where they are used.
"""

from __future__ import annotations

import numpy as np


def attention_flops(
    b: int, h: int, nq: int, nk: int, d: int, *, causal: bool, mode: str,
    window: tuple[int, int] | None = None,
) -> float:
    """``fpm = 2·B·H·Nq·Nk·D``; fwd = 2·fpm, bwd = 5·fpm, fwd+bwd = 7·fpm;
    ×0.5 when causal.

    ``window=(left, right)``: band-area accounting -- ``Nq·Nk`` is replaced by
    the exact number of live (i, j) pairs of the band (row i attends to
    ``i−left ≤ j ≤ i+right``, ANDed with causal, clipped to ``[0, Nk)``)."""
    mult = {"fwd": 2.0, "bwd": 5.0, "fwd_bwd": 7.0}[mode]
    if window is not None:
        left, right = window
        i = np.arange(nq, dtype=np.int64)
        lo = i - left if left >= 0 else np.zeros_like(i)
        hi = i + right if right >= 0 else np.full_like(i, nk - 1)
        if causal:
            hi = np.minimum(hi, i)
        lo = np.clip(lo, 0, nk - 1)
        hi = np.clip(hi, -1, nk - 1)
        area = float(np.maximum(hi - lo + 1, 0).sum())
        return mult * 2.0 * b * h * area * d
    f = mult * 2.0 * b * h * nq * nk * d
    return f * 0.5 if causal else f
