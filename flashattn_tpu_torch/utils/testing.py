"""Testing helpers: seeded inputs, explicit per-dtype tolerances.

Port of flashattn_tpu/utils/testing.py with the same budgets. Inputs come from
a numpy seed rather than a JAX key, so a test can hand the very same arrays to
the JAX package and to the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Tolerance(NamedTuple):
    atol: float
    rtol: float


# Max-abs-error budgets vs the f32 exact oracle, sized from the dtype's
# round-off on O(1) attention outputs (the JAX package's budgets, unchanged).
FWD_TOL = {
    torch.float32: Tolerance(1e-4, 1e-4),
    torch.bfloat16: Tolerance(2e-2, 2e-2),
    # fp16 inputs run through the bf16 kernel path (the dtype dispatch casts
    # them), so their error is bf16-class.
    torch.float16: Tolerance(2e-2, 2e-2),
}
# Gradients amplify round-off through the dS = P (dP - Delta) cancellation, so
# their budgets are looser (the JAX package's budgets, unchanged).
BWD_TOL = {
    torch.float32: Tolerance(1e-3, 5e-4),
    torch.bfloat16: Tolerance(8e-2, 8e-2),
    torch.float16: Tolerance(8e-2, 8e-2),
}


def make_qkv(
    seed: int,
    B: int,
    H: int,
    Nq: int,
    D: int,
    *,
    Nk: int | None = None,
    Hkv: int | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
):
    """Random Q/K/V in `[B,H,N,D]`, unit-scale normal, drawn in f32 by
    ``numpy.random.default_rng(seed)`` and then cast to ``dtype``."""
    Nk = Nq if Nk is None else Nk
    Hkv = H if Hkv is None else Hkv
    rng = np.random.default_rng(seed)
    shapes = ((B, H, Nq, D), (B, Hkv, Nk, D), (B, Hkv, Nk, D))
    return tuple(
        torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
            device=device, dtype=dtype)
        for s in shapes)


def _as_f32_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def check_close(actual, expected, tol: Tolerance, name: str = "out"):
    """Per-element ``|a−e| ≤ atol + rtol·|e|`` check (the numpy.allclose
    criterion, no whole-tensor escape). Takes tensors or arrays. Returns
    (ok, message)."""
    a = _as_f32_numpy(actual)
    e = _as_f32_numpy(expected)
    if a.shape != e.shape:
        return False, f"{name}: shape {a.shape} != {e.shape}"
    if a.size == 0:
        return True, f"{name}: empty"
    err = np.abs(a - e)
    budget = tol.atol + tol.rtol * np.abs(e)
    excess = err - budget
    worst = int(np.argmax(excess))
    ok = bool(excess.flat[worst] <= 0.0)
    msg = (
        f"{name}: max_abs_err={err.max():.3e}, worst element "
        f"|a−e|={err.flat[worst]:.3e} vs budget {budget.flat[worst]:.3e} "
        f"(atol {tol.atol:.1e} + rtol {tol.rtol:.1e}·|e|, "
        f"e={e.flat[worst]:.3e}) at flat index {worst}"
    )
    return ok, msg


def assert_close(actual, expected, tol: Tolerance, name: str = "out"):
    """Assert per-element ``|a−e| ≤ atol + rtol·|e|``."""
    ok, msg = check_close(actual, expected, tol, name)
    assert ok, msg


def grad_gate(grads, grads_want, tol: Tolerance, names=("dq", "dk", "dv")):
    """Per-element gate over a tuple of gradient tensors. Returns
    ``(ok, why, grad_maxdiff, grad_maxrel)``: the max-abs and max-relative
    (relative to ``max(|want|, 1)``) differences are reported, the pass/fail
    decision is per element."""
    gmd = gmr = 0.0
    ok, why = True, ""
    for name, a, b in zip(names, grads, grads_want):
        a, b = _as_f32_numpy(a), _as_f32_numpy(b)
        d = np.abs(a - b)
        gmd = max(gmd, float(d.max()))
        gmr = max(gmr, float((d / np.maximum(np.abs(b), 1.0)).max()))
        gok, msg = check_close(a, b, tol, name)
        if not gok:
            ok, why = False, (why + "; " + msg if why else msg)
    return ok, why, gmd, gmr
