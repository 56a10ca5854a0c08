"""Timing harness and the attention FLOP model (port of flashattn_tpu/utils/timing.py).

:func:`time_chained_stats` keeps the JAX harness's rule: run a chain of
``n`` data-dependent steps, time a short and a long chain, and take the
median of the differenced samples, with its spread beside it. On the card
each chain is timed with CUDA events (the device's own clock, so host
dispatch that keeps up costs nothing); on the CPU with the host clock.
Every TFLOP/s figure of the port is computed with :func:`attention_flops`,
as the JAX package's are.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def time_chained_stats(
    step: Callable,
    carry0,
    *,
    consts=(),
    iters: int = 64,
    warmup_iters: int = 8,
    repeats: int = 5,
) -> dict:
    """Per-iteration timing statistics of ``carry = step(carry, *consts)``.

    ``step`` maps a carry (tensors, possibly nested in tuples, lists or
    dicts) to a like-shaped carry, so each step depends on the last. A short
    (``warmup_iters``) and a long (``iters``) chain are timed and
    differenced, which cancels the fixed cost of starting and ending a
    chain; chains on a CUDA tensor are timed with CUDA events, others with
    the host clock. The figure is the MEDIAN of ``repeats`` differenced
    samples (the min is biased fast by a stall in the short chain), and the
    chains grow 4x at a time until the differenced span reaches 50 ms
    (``n_long`` at most 4096). Returns ``{"per_iter": median_s, "spread":
    (max − max(min, 0)) / median, "samples": [...]}``.
    """
    ref = _first_tensor(carry0)
    cuda = ref is not None and ref.device.type == "cuda"

    def chain(n):
        carry = carry0
        for _ in range(n):
            carry = step(carry, *consts)
        return carry

    def timed(n) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        chain(n)
        return time.perf_counter() - t0

    def measure(n_short, n_long):
        timed(n_short)
        timed(n_long)  # warm both chain lengths
        samples = []
        for _ in range(repeats):
            t_short = timed(n_short)
            t_long = timed(n_long)
            samples.append((t_long - t_short) / (n_long - n_short))
        return samples

    n_short, n_long = warmup_iters, iters
    samples = measure(n_short, n_long)
    while _median(samples) * (n_long - n_short) < 50e-3 and n_long < 4096:
        n_short, n_long = n_long, n_long * 4
        samples = measure(n_short, n_long)
    med = max(_median(samples), 1e-9)
    lo, hi = min(samples), max(samples)
    return {
        "per_iter": med,
        "spread": (hi - max(lo, 0.0)) / med,
        "samples": [round(s, 9) for s in samples],
    }


def time_chained(
    step: Callable,
    carry0,
    *,
    consts=(),
    iters: int = 64,
    warmup_iters: int = 8,
    repeats: int = 5,
) -> float:
    """Median seconds/iteration -- see :func:`time_chained_stats`."""
    return time_chained_stats(
        step, carry0, consts=consts, iters=iters, warmup_iters=warmup_iters,
        repeats=repeats,
    )["per_iter"]


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
