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


def sample_composition(rng: np.random.Generator) -> dict:
    """One draw of the composition fuzz: every option of ``flash_attention``
    sampled jointly from ``rng`` (a ``numpy.random.Generator``), as the JAX
    package's fuzz draws them (tests/test_fuzz_compose.py ``_sample_case``:
    B, GQA, causal, a window, segment ids, a bias of every broadcast shape
    ``[1|B, 1|Hq, Nq|1, Nk]``, the softcap, f32 or bf16, the layout, ragged
    Nq / Nk, q / kv offsets) and beyond it: offsets with segment ids, causal
    with Nq != Nk, head dims 136-256 in bf16 and f32 (the kernels' D 256
    forms), and decode-class Nq down to 1 with every option but
    causal. Returns plain values and numpy arrays (``seg``: int32 ``[B,
    Nq]`` and ``[B, Nk]`` ids, or None), so the port and the JAX package can
    take the same draw."""
    B = int(rng.integers(1, 3))
    Hkv = int(rng.integers(1, 3))
    Hq = Hkv * int(rng.choice([1, 2, 3]))
    dtype = torch.float32 if rng.random() < 0.6 else torch.bfloat16
    wide = rng.random() < 0.25
    D = int(rng.choice([136, 160, 192, 256] if wide else [32, 64, 72, 80, 128]))
    Nq = int(rng.integers(17, 400))
    Nk = Nq if rng.random() < 0.6 else int(rng.integers(17, 400))
    decode = rng.random() < 0.15
    if decode:
        Nq = int(rng.integers(1, 17))  # decode-class tiny Q
    causal = not decode and bool(rng.random() < 0.5)
    window = None
    if rng.random() < 0.3:
        wl = int(rng.integers(0, max(Nq, Nk))) if rng.random() < 0.8 else -1
        wr = -1 if causal else (int(rng.integers(0, 64)) if rng.random() < 0.5 else -1)
        if wl >= 0 or wr >= 0:
            window = (wl, wr)
    seg = None
    if rng.random() < 0.4:
        n_seg = int(rng.integers(1, 5))

        def ids(n):
            cuts = np.sort(rng.choice(n, size=min(n_seg - 1, n - 1), replace=False))
            out = np.zeros((B, n), np.int32)
            for c in cuts:
                out[:, c:] += 1
            return out

        seg = (ids(Nq), ids(Nk))
    bias_shape = None
    if rng.random() < 0.3:
        bias_shape = (1 if rng.random() < 0.5 else B, 1 if rng.random() < 0.5 else Hq,
                      1 if rng.random() < 0.25 else Nq, Nk)
    softcap = float(rng.choice([15.0, 50.0])) if rng.random() < 0.3 else None
    # Ring-style absolute offsets: they shift the causal / window band, with
    # or without segment ids, so some pairs put whole rows or tiles outside it.
    q_off = kv_off = 0
    if (causal or window is not None) and rng.random() < 0.4:
        q_off = int(rng.integers(0, 3)) * 128
        kv_off = int(rng.integers(0, 3)) * 128
    layout = "BNHD" if rng.random() < 0.25 else "BHND"
    return dict(B=B, Hq=Hq, Hkv=Hkv, D=D, Nq=Nq, Nk=Nk, causal=causal, window=window, seg=seg,
                bias_shape=bias_shape, softcap=softcap, dtype=dtype, q_off=q_off, kv_off=kv_off,
                layout=layout)


def composition_inputs(case: dict, seed: int) -> dict:
    """The numpy inputs of a :func:`sample_composition` draw, from ``seed``:
    q ``[B, Hq, Nq, D]``, k / v ``[B, Hkv, Nk, D]``, the output's cotangent
    ``do`` like q (all unit normal, f32, rounded to bf16 for a bf16 draw) and
    the bias (``0.5`` times unit normal, f32) of the draw's shape, or None."""
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, Nq, Nk, D = (case[n] for n in ("B", "Hq", "Hkv", "Nq", "Nk", "D"))

    def draw(*shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        if case["dtype"] == torch.bfloat16:
            x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        return x

    q, k, v, do = draw(B, Hq, Nq, D), draw(B, Hkv, Nk, D), draw(B, Hkv, Nk, D), draw(B, Hq, Nq, D)
    bias = None
    if case["bias_shape"] is not None:
        bias = 0.5 * rng.standard_normal(case["bias_shape"], dtype=np.float32)
    return dict(q=q, k=k, v=v, do=do, bias=bias)
