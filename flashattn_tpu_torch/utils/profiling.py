"""Profiling & trace capture (port of flashattn_tpu/utils/profiling.py).

The JAX module's names with PyTorch's and the CUDA toolkit's tools inside:

  * :func:`trace` / :func:`capture_attention_trace` run ``torch.profiler``
    around a region and write a Chrome trace (``trace.json``, which Perfetto
    and ``chrome://tracing`` open) into a directory -- the role of
    ``jax.profiler``'s trace directory;
  * :func:`annotate` labels a region of the trace
    (``torch.profiler.record_function``, the ``TraceAnnotation`` role);
  * :func:`dump_kernel_ir` keeps the generated code for inspection offline:
    the PTX of the kernel sources (``nvcc -ptx`` for ``sm_90a``) and
    the SASS of the built library (the toolkit's ``cuobjdump -sass``), where
    the JAX function keeps the lowered StableHLO and HLO.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile

import torch

TRACE_FILE = "trace.json"


def _default_dir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


@contextlib.contextmanager
def trace(log_dir: str | None = None, *, host: bool = False):
    """Capture a trace around a code region into ``log_dir`` (default: a
    ``flashattn_tpu_torch_trace`` directory under the temporary directory),
    written as the Chrome trace ``log_dir/trace.json`` when the region ends.
    It records the host's operators and :func:`annotate`'s regions, the
    card's kernels when a card is present, and with ``host`` the Python call
    stacks of the host's work. Usage::

        with trace("tr"):
            flash_attention(q, k, v)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = _default_dir("flashattn_tpu_torch_trace") if log_dir is None else log_dir
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, with_stack=host) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Label a region in the captured trace (``record_function`` context)."""
    return torch.profiler.record_function(name)


def dump_kernel_ir(out_dir: str | None = None, *, name: str = "kernel",
                   sources: tuple[str, ...] | None = None) -> dict:
    """Save the generated code of the port's kernels -- the ``-save-temps``
    role: the PTX of each kernel source (``sources``, file names under
    ``csrc/``; default all), compiled for ``sm_90a`` as the build compiles
    it, and the SASS of the built library (``cuobjdump -sass``, building it
    first if it is missing or stale). Needs the CUDA toolkit (``native.find_nvcc``
    raises without it). Returns ``{"ptx": [path, ...], "sass": path}``."""
    from flashattn_tpu_torch.utils import native

    out_dir = _default_dir("flashattn_tpu_torch_ir") if out_dir is None else out_dir
    os.makedirs(out_dir, exist_ok=True)
    nvcc = native.find_nvcc()
    srcs = (sorted(native.CSRC.glob("*.cu")) if sources is None
            else [native.CSRC / s for s in sources])
    ptx = [os.path.join(out_dir, f"{name}.{s.stem}.ptx") for s in srcs]
    native._run_all([[nvcc, "-arch=sm_90a", "-std=c++17", "-O3", "-ptx", "-o", p, str(s)]
                     for s, p in zip(srcs, ptx)])
    lib, _ = native.build()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = os.path.join(out_dir, f"{name}.sass.txt")
    with open(sass, "w") as f:
        subprocess.run([cuobjdump, "-sass", str(lib)], stdout=f, check=True)
    return {"ptx": ptx, "sass": sass}


def capture_attention_trace(
    out_dir: str | None = None,
    *,
    B: int = 1, H: int = 24, N: int = 4096, D: int = 128,
    causal: bool = False, with_bwd: bool = True, device="cuda",
) -> str:
    """One-shot capture of fused attention fwd (+ bwd) at the JAX function's
    defaults (B1 H24 N4096 D128, bf16): ``flash_attention`` -- K1 -- and its
    gradient -- K3 -- each run once outside the trace (the build and the
    first launches stay out of it), then once under :func:`trace`, labelled
    ``flash_fwd`` / ``flash_bwd``. On the card by default; ``device="cpu"``
    runs the plain versions. Returns the trace directory."""
    from flashattn_tpu_torch.ops.flash import flash_attention
    from flashattn_tpu_torch.utils.testing import make_qkv

    q, k, v = make_qkv(0, B, H, N, D, dtype=torch.bfloat16, device=device)

    def fwd():
        with torch.no_grad():
            return flash_attention(q, k, v, causal=causal)

    def bwd():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = flash_attention(*leaves, causal=causal).float().sum()
        return torch.autograd.grad(out, leaves)

    fwd()
    if with_bwd:
        bwd()
    with trace(out_dir) as log_dir:
        with annotate("flash_fwd"):
            fwd()
        if with_bwd:
            with annotate("flash_bwd"):
                bwd()
    return log_dir
