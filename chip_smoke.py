"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``flashattn_tpu_torch/csrc/`` with nvcc (one
nvcc per source, in parallel) and holds each against its plain PyTorch version
at the shapes its paths give it: K1 non-causal (serving), K1 causal (which
also stands for K2), the backward K3 (which also stands for K4), K1 with
segment ids and the two-kernel backward K5 (dK/dV) + K6 (dQ) of packed
training, K1's decode variants (bias; int8 / fp8 K/V), the sliding-window
and soft-capped variants of K1, K3, K5 and K6, K5 and K6 with a bias (K6 with
dbias), and the probes K9 (GEMM) and K10 (tensor-core peak). Then it drives
the port's paths and checks that each went through its kernels:

* serving: Euler sampling over the SD1.5 U-Net at full width (random weights
  from a seed, 64x64 latent, 77-token context), fused vs exact attention;
* training: the Llama-class LM at the width of benchmarks/bench_lm.py
  (443 M parameters, bf16, random weights from a seed, one 2049-token row),
  loss and gradient gates fused vs exact attention, then 10 AdamW steps per
  arm;
* packed training: the same LM on rows of 8 packed documents (bench_lm.py's
  packed cell): gates at [1, 2049] tokens, then 10 fused AdamW steps at
  [2, 4097] tokens beside 10 unpacked steps at the same shape;
* LM serving: KV-cache decode of the LM of benchmarks/bench_decode.py (821 M
  parameters, 16 layers, bf16) on a bf16, int8 and fp8 cache -- K1 with the
  cache-slot bias, and K1 dequantizing int8 / fp8 K/V in the kernel, checked
  first against their plain version at bench_decode's attention shapes:
  gates against the teacher-forced forward and between cache dtypes, 8
  requests per cache dtype (16 K1 launches per step), ms/token at cache
  lengths 1024-8192;
* sliding-window training (bench_lm.py's long-context cells): the same LM
  with ``sliding_window=2048``, gates at [1, 2049] tokens with a window of
  512, 10 AdamW steps at [1, 8193] beside 10 full-causal steps, and a few
  steps at [1, 16385] with ``remat=True``;
* soft-capped training and decode: the LM with ``logit_softcap=50.0`` (and
  the window), gates at [1, 2049] and 10 steps at [1, 8193]; bench_decode's
  LM with the cap on a bf16 cache, decode against the teacher-forced forward
  and ms/token at cache lengths 1024-8192;
* bias-gradient training (path A): the counterpart of flax's
  MultiHeadDotProductAttention (integrations/torch_nn.py, 16 heads of 128,
  impl "fused") on x [4, 2048, 2048] bf16 with a key-padding mask of row
  lengths 2048-512: loss and gradient gates fused vs exact, then 10 AdamW
  steps per arm -- K1, K5 and K6 with the bias; first K5 with a bias and K6
  with a bias and dbias against their plain versions at the LM's attention
  shape with a learned [1, 16, 2048, 2048] bias, and flash_attention(bias=)
  end to end against autograd through the f32 oracle;
* the roofline probes (path B): K9 (gemm.matmul) at 4096^3 and K10
  (measure_mxu_peak_tflops) against their plain versions, K10's HMMA count in
  the SASS, and the measured mma.sync and chained torch.matmul peaks beside
  the datasheet's 989 TFLOP/s.

Every kernel's line in the kernels JSON carries its time, its plain version's
time, its bound (the larger of the bytes it must move at 3.35 TB/s and its
tensor-core FLOPs at 989 TFLOP/s, the H100 SXM's datasheet peaks) and the
time of one PyTorch call that computes the same function
(``scaled_dot_product_attention``, forward or backward; ``flex_attention``
compiled by ``torch.compile`` where a softcap or segment ids rule SDPA out),
or null with the reason where none does (quantized K/V).

One line per phase; the last two lines are a JSON object of the kernels'
numbers and ``{"ok": true, "device": ...}``. Exits non-zero, before printing
any result, when there is no CUDA device or when any phase fails. Imports
nothing of JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
STEPS = 20
REQUESTS = 2
LATENT = 64        # SD1.5 at 512x512 pixels
CONTEXT_LEN = 77   # CLIP text tokens
O_TOL_NAME = "FWD_TOL[bf16]"
LSE_ATOL = 1e-3
REL_L2_LIMIT = 2e-2
# The LM of benchmarks/bench_lm.py:122-125 (full depth) and its step.
LM_WIDTH = dict(vocab_size=32000, d_model=2048, n_layers=8, n_heads=16, n_kv_heads=8,
                d_head=128, d_ff=5632)
LM_SEQ = 2048
LM_STEPS = 10
LM_WARMUP = 2
# Gradient gate, fused vs xla: relative L2 over all parameter gradients. The
# bf16 noise floor (each arm against an f32 copy of the model) is measured
# and printed in every run: 2.07e-2 on the H100, so the limit sits 1.5x above.
GRAD_REL_L2_LIMIT = 3e-2
# Packed training (bench_lm.py's packed cell): the gates run at [1, 2049]
# tokens in 8 documents, the steps at [2, 4097] with 8 documents per row. The
# packed bf16 floor measured 2.027e-2 on the H100 (fused vs the f32 model),
# above 2e-2, so the limit is 1.5x that floor.
PACKED_GRAD_REL_L2_LIMIT = 3.04e-2
PACKED_SHAPE = (2, 4096)
# Sliding-window training (bench_lm.py:141-151): window 2048 at B1 N8192, and
# with remat at N16384; the gates run at [1, 2049] with a window of 512, so
# the window binds where the xla arm fits. Soft-capped training and decode
# take Gemma-2's attn_logit_softcapping, 50.0.
SWA_WINDOW = 2048
SWA_SEQ = 8192
SWA_REMAT_SEQ = 16384
SWA_REMAT_STEPS = 4
GATE_WINDOW = 512
SOFTCAP = 50.0
# The H100 SXM's datasheet peaks:
# dense bf16 tensor-core FLOP/s and HBM3 bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, *, reps: int = 20, trials: int = 5) -> float:
    """Median over ``trials`` of the mean CUDA-event time of ``reps`` calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def tensor_bytes(*xs) -> int:
    """Bytes of the given tensors (None counts 0): each read or written once."""
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over the
    HBM rate and ``flops`` over the bf16 tensor-core rate, and which one."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pair_flops(q, k, *, matmuls: int, **mask) -> float:
    """Tensor-core FLOPs of ``matmuls`` products of depth D over the (query,
    key) pairs that these inputs attend (``flash_fwd.pair_mask`` of ``mask``,
    counted on the card): 2·D per pair per product, over batch and q heads."""
    from flashattn_tpu_torch.ops import flash_fwd

    B, Hq, Nq, D = q.shape
    keep = flash_fwd.pair_mask(Nq, k.shape[2], device=q.device, **mask)
    pairs = float(keep.expand(B, 1, Nq, k.shape[2]).sum().item()) * Hq
    return 2.0 * D * pairs * matmuls


def sdpa_ms(q, k, v, *, do=None, bias_leaf=None, **kw) -> float:
    """The library yardstick: one ``scaled_dot_product_attention`` call at
    its best backend on the same inputs (``enable_gqa`` for Hkv < Hq), or,
    with ``do``, the one backward call of that attention (dQ, dK, dV from the
    saved forward, and the gradient of ``bias_leaf``, a tensor that requires
    grad and from which ``attn_mask`` was computed: SDPA's dbias). Timed
    here, used nowhere in the port."""
    import torch.nn.functional as F

    kw.setdefault("enable_gqa", k.shape[1] != q.shape[1])
    if do is None:
        with torch.no_grad():
            return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw), reps=5,
                           trials=3)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
    leaves = (qg, kg, vg) + (() if bias_leaf is None else (bias_leaf,))
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                   reps=5, trials=3)


def flex_ms(q, k, v, *, scale: float, do=None, score_mod=None, mask_mod=None) -> float:
    """The library yardstick where no SDPA call computes the function (a
    logit softcap, segment ids): one call of ``flex_attention`` compiled by
    ``torch.compile`` (Triton), with ``score_mod`` and the block mask of
    ``mask_mod``, on contiguous copies of the same inputs; with ``do``, its
    one backward call (dQ, dK and dV together). The warm-up compiles it
    (Inductor's and Triton's caches go to the port's build directory). Timed
    here, used nowhere in the port."""
    from flashattn_tpu_torch.utils import native

    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(native.BUILD_DIR / sub))
    from torch._functorch import config as functorch_config
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    flex = torch.compile(flex_attention)
    block = None if mask_mod is None else create_block_mask(
        mask_mod, q.shape[0], None, q.shape[2], k.shape[2], device=q.device)
    kw = dict(score_mod=score_mod, block_mask=block, scale=scale,
              enable_gqa=k.shape[1] != q.shape[1])
    q, k, v = (x.contiguous() for x in (q, k, v))
    if do is None:
        with torch.no_grad():
            return cuda_ms(lambda: flex(q, k, v, **kw), reps=5, trials=3)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    # The one graph's backward is timed again and again (retain_graph), which
    # a compiled backward that donates its saved buffers refuses.
    with functorch_config.patch(donated_buffer=False):
        out = flex(qg, kg, vg, **kw)
        return cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
                       reps=5, trials=3)


def softcap_mod(cap: float, bias=None):
    """flex_attention's ``score_mod`` of K1's softcap: ``cap·tanh(s/cap)`` on
    the scaled score, then ``bias [1, 1, 1, Nk]`` by key (the HF Gemma-2
    order, flash_fwd.py:310-318)."""
    def mod(score, b, h, q_idx, kv_idx):
        score = cap * torch.tanh(score / cap)
        return score if bias is None else score + bias[0, 0, 0, kv_idx]
    return mod


def band_mod(lo: int, ids=None):
    """flex_attention's ``mask_mod`` of causal attention with a left bound
    ``lo`` (None: none) and segment ids ``ids [B, N]`` (None: none)."""
    def mod(b, h, q_idx, kv_idx):
        keep = q_idx >= kv_idx
        if lo is not None:
            keep = keep & (q_idx - kv_idx <= lo)
        if ids is not None:
            keep = keep & (ids[b, q_idx] == ids[b, kv_idx])
        return keep
    return mod


def predicted_fused_calls(cfg, h: int, w: int, ctx_len: int) -> int:
    """K1 launches per U-Net forward: attention calls that the SDPA adapter's
    ``_exact_is_faster`` rule sends to the fused kernel (self-attention
    N x N and cross-attention N x ctx_len at every transformer block)."""
    from flashattn_tpu_torch.ops.sdpa import _exact_is_faster

    calls, last = 0, len(cfg.channel_mult) - 1
    for level in range(len(cfg.channel_mult)):
        n = h * w
        fused_per_block = cfg.depth_at(level) * (
            (not _exact_is_faster(n, n)) + (not _exact_is_faster(n, ctx_len)))
        if level in cfg.attn_levels:  # num_res_blocks down, num_res_blocks + 1 up
            calls += fused_per_block * (2 * cfg.num_res_blocks + 1)
        if level == last:             # the mid block
            calls += fused_per_block
        h, w = -(-h // 2), -(-w // 2)
    return calls


def phase_env() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
               f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from flashattn_tpu_torch.utils import native

    nvcc = subprocess.run([native.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log("env", f"nvcc: {nvcc}")


def phase_build() -> None:
    from flashattn_tpu_torch.utils import native

    t0 = time.perf_counter()
    lib, out = native.build(("-Xptxas", "-v"))
    native.kernels()
    sources = ", ".join(p.name for p in sorted(native.CSRC.glob("*.cu")))
    log("build", f"{sources} built from {native.CSRC.relative_to(native.CSRC.parent.parent)} "
                 f"into {lib.name} in {time.perf_counter() - t0:.2f} s")
    stats = ptxas_stats(out)
    for name, (regs, stack, spill_st, spill_ld) in stats.items():
        log("build", f"{name}: {regs} registers, {stack} B stack frame, {spill_st} B spill "
                     f"stores, {spill_ld} B spill loads")
    log("build", f"{len(stats)} kernel instantiations")


def ptxas_stats(out: str) -> dict:
    """``ptxas -v`` output as {instantiation_name: (registers, stack frame
    bytes, spill store bytes, spill load bytes)}."""
    stats = {}
    for entry in re.split(r"Compiling entry function", out)[1:]:
        mangled = entry.split("'")[1] if entry.count("'") >= 2 else entry[:120]
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", entry)
        if regs and spill:
            stats[instantiation_name(mangled)] = (int(regs.group(1)), *map(int, spill.groups()))
    return stats


def instantiation_name(mangled: str) -> str:
    """The kernel (K1 and its variant, K3, K5, K6) and template arguments of
    a mangled instantiation name from ptxas, e.g. ``K1 int8 bias
    fwd_kernel<128, 0, 1, 1>`` or ``K5 softcap dkv_softcap_kernel<128>``; an
    unrecognised name comes back marked as such, never raising."""
    probe = re.search(r"(gemm|roofline)_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if probe:
        args = re.findall(r"L[a-z]+(-?\d+)E", probe.group(2))
        return (f"{'K9' if probe.group(1) == 'gemm' else 'K10'} "
                f"{probe.group(1)}_kernel<{', '.join(args)}>")
    m = re.search(r"(fwd|dkv|dq)(_softcap|_window|_bias)?_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if not m:
        return f"unrecognised instantiation {mangled}"
    kind, family = m.group(1), m.group(2) or ""
    args = [int(a) for a in re.findall(r"L[a-z]+(-?\d+)E", m.group(3))]
    label = f"{kind}{family}_kernel<{', '.join(map(str, args))}>"
    # Template arguments after DP, by kernel: K1 fwd_kernel<DP, SEG, BIAS, KV>,
    # fwd_softcap_kernel<DP, SEG, BIAS>, fwd_window_kernel<DP, SEG, CAP>; K3/K5
    # dkv_kernel<DP, DQ>, dkv_softcap_kernel<DP>, dkv_window_kernel<DP, DQ, CAP>;
    # K6 dq_kernel<DP>, dq_softcap_kernel<DP>, dq_window_kernel<DP, CAP>; K5/K6
    # with a bias dkv_bias_kernel<DP, CAP>, dq_bias_kernel<DP, CAP>. K9
    # gemm_kernel<OUT_F32>, K10 roofline_kernel<CHAINS> (above).
    params = {("fwd", ""): ("seg", "bias", "kv"), ("fwd", "_softcap"): ("seg", "bias"),
              ("fwd", "_window"): ("seg", "cap"), ("dkv", ""): ("dq",), ("dkv", "_softcap"): (),
              ("dkv", "_window"): ("dq", "cap"), ("dkv", "_bias"): ("cap",), ("dq", ""): (),
              ("dq", "_softcap"): (), ("dq", "_window"): ("cap",),
              ("dq", "_bias"): ("cap",)}.get((kind, family))
    if params is None or len(args) != 1 + len(params):
        return f"unrecognised instantiation {label}"
    a = dict(zip(params, args[1:]))
    cap = family == "_softcap" or a.get("cap")
    window = family == "_window"
    if kind == "fwd":
        variant = {0: "", 1: " int8", 2: " fp8"}.get(a.get("kv", 0), f" kv{a.get('kv')}")
        return (f"K1{variant}{' softcap' if cap else ''}{' window' if window else ''}"
                f"{' bias' if a.get('bias') else ''}{' segments' if a['seg'] else ''} {label}")
    name = "K6" if kind == "dq" else "K3" if a.get("dq") else "K5"
    return (f"{name}{' softcap' if cap else ''}{' window' if window else ''}"
            f"{' bias' if family == '_bias' else ''} {label}")


def sass_opcodes(lib, names: set) -> dict:
    """{instantiation name: Counter of SASS opcodes} for the kernels of the
    library ``lib`` named in ``names`` (:func:`instantiation_name`), from
    ``cuobjdump -sass``."""
    from flashattn_tpu_torch.utils import native

    cuobjdump = os.path.join(os.path.dirname(native.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    ops, current = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = instantiation_name(fn.group(1))
            current = ops.setdefault(name, collections.Counter()) if name in names else None
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)", line)
        if current is not None and op:
            current[op.group(1)] += 1
    return ops


def _bnhd(x):
    """``x`` as a [B, H, N, D] view of [B, N, H, D] memory (the models' layout)."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def phase_kernel_check() -> dict:
    from flashattn_tpu_torch.ops import flash_fwd
    from flashattn_tpu_torch.utils.testing import FWD_TOL, Tolerance, check_close, make_qkv

    o_tol, lse_tol = FWD_TOL[torch.bfloat16], Tolerance(LSE_ATOL, 0.0)
    # (name, B, Hq, Nq, D, Nk, Hkv, BNHD layout)
    # "slice": the level-0 self-attention of SD1.5 at a 64x64 latent
    cases = [("slice", 1, 8, 4096, 40, 4096, 8, True)]
    cases += [(f"D{d}", 1, 8, 1024, d, 1024, 8, True) for d in (64, 80, 128, 160)]
    cases += [(f"Nq1537-Nk{nk}", 1, 8, 1537, 40, nk, 8, True) for nk in (77, 1537)]
    cases += [("GQA-8/2", 1, 8, 1024, 64, 1024, 2, False), ("B2", 2, 8, 1024, 40, 1024, 8, True)]
    slice_err = None
    for i, (name, B, Hq, Nq, D, Nk, Hkv, bnhd) in enumerate(cases):
        q, k, v = make_qkv(100 + i, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv, dtype=torch.bfloat16,
                           device=DEVICE)
        if bnhd:
            q, k, v = (_bnhd(x) for x in (q, k, v))
        o, lse = flash_fwd.fwd(q, k, v, scale=D ** -0.5)
        torch.cuda.synchronize()
        o_want, lse_want = flash_fwd.fwd_reference(q.float(), k.float(), v.float(), scale=D ** -0.5)
        ok_o, msg_o = check_close(o, o_want, o_tol, "O")
        ok_l, msg_l = check_close(lse, lse_want, lse_tol, "LSE")
        err = (o.float() - o_want).abs().max().item()
        log("kernel", f"{name} B{B} Hq{Hq} Hkv{Hkv} Nq{Nq} Nk{Nk} D{D} "
                      f"{'BNHD' if bnhd else 'BHND'}: O max_abs_err {err:.3e} "
                      f"(budget {O_TOL_NAME} atol {o_tol.atol} rtol {o_tol.rtol}), "
                      f"LSE max_abs_err {(lse - lse_want).abs().max().item():.3e} "
                      f"(budget {LSE_ATOL}), synchronize ok")
        if not (ok_o and ok_l):
            fail(f"K1 disagrees with fwd_reference at {name}: {msg_o}; {msg_l}")
        if name == "slice":
            slice_err = err
            q_s, k_s, v_s, d_s = q, k, v, D

    ms = cuda_ms(lambda: flash_fwd.fwd(q_s, k_s, v_s, scale=d_s ** -0.5))
    plain_ms = cuda_ms(lambda: flash_fwd.fwd_reference(q_s, k_s, v_s, scale=d_s ** -0.5))
    res = {"max_abs_err": slice_err, "ms": ms, "plain_ms": plain_ms,
           **bound(tensor_bytes(q_s, k_s, v_s, q_s) + 4 * q_s.numel() // d_s,
                   pair_flops(q_s, k_s, matmuls=2, kv_valid_len=k_s.shape[2], causal=False,
                              segment_ids=None)),
           "library_ms": sdpa_ms(q_s, k_s, v_s), "library_call": "scaled_dot_product_attention"}
    log("kernel", f"slice shape B1 H8 N4096 D40 bf16: K1 {ms:.4f} ms, plain version "
                  f"{plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
                  f"SDPA {res['library_ms']:.4f} ms (median CUDA-event time)")
    return res


# (name, B, Hq, Hkv, Nq, Nk, D): the LM's attention and the routes K2/K4
# take on the TPU (N1536: the resident causal routes), ragged, top-left
# causal with Nq < Nk, a smaller head dim.
CAUSAL_CASES = [("lm", 1, 16, 8, 2048, 2048, 128), ("N1536", 1, 16, 8, 1536, 1536, 128),
                ("N1537", 1, 16, 8, 1537, 1537, 128), ("Nq256-Nk1024", 1, 16, 8, 256, 1024, 128),
                ("D64-B2", 2, 8, 8, 1024, 1024, 64)]


def phase_causal_check() -> dict:
    from flashattn_tpu_torch.ops import flash_fwd
    from flashattn_tpu_torch.utils.testing import FWD_TOL, Tolerance, check_close, make_qkv
    from flashattn_tpu_torch.utils.timing import attention_flops

    o_tol, lse_tol = FWD_TOL[torch.bfloat16], Tolerance(LSE_ATOL, 0.0)
    for i, (name, B, Hq, Hkv, Nq, Nk, D) in enumerate(CAUSAL_CASES):
        q, k, v = (_bnhd(x) for x in make_qkv(200 + i, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv,
                                               dtype=torch.bfloat16, device=DEVICE))
        o, lse = flash_fwd.fwd(q, k, v, scale=D ** -0.5, causal=True)
        torch.cuda.synchronize()
        o_want, lse_want = flash_fwd.fwd_reference(q.float(), k.float(), v.float(),
                                                   scale=D ** -0.5, causal=True)
        ok_o, msg_o = check_close(o, o_want, o_tol, "O")
        ok_l, msg_l = check_close(lse, lse_want, lse_tol, "LSE")
        err = (o.float() - o_want).abs().max().item()
        log("kernel", f"K1 causal {name} B{B} Hq{Hq} Hkv{Hkv} Nq{Nq} Nk{Nk} D{D} BNHD: O "
                      f"max_abs_err {err:.3e} (budget {O_TOL_NAME}), LSE max_abs_err "
                      f"{(lse - lse_want).abs().max().item():.3e} (budget {LSE_ATOL})")
        if not (ok_o and ok_l):
            fail(f"K1 causal disagrees with fwd_reference at {name}: {msg_o}; {msg_l}")
        if name == "lm":
            res = {"max_abs_err": err}
            q_s, k_s, v_s = q, k, v
    B, Hq, Hkv, N, _, D = CAUSAL_CASES[0][1:]
    res["ms"] = cuda_ms(lambda: flash_fwd.fwd(q_s, k_s, v_s, scale=D ** -0.5, causal=True))
    res["plain_ms"] = cuda_ms(lambda: flash_fwd.fwd_reference(q_s, k_s, v_s, scale=D ** -0.5,
                                                              causal=True), reps=5)
    tf = attention_flops(B, Hq, N, N, D, causal=True, mode="fwd") / 1e9
    res.update(bound(tensor_bytes(q_s, k_s, v_s, q_s) + 4 * B * Hq * N, tf * 1e9))
    res["library_ms"] = sdpa_ms(q_s, k_s, v_s, is_causal=True)
    res["library_call"] = "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
    log("kernel", f"lm shape B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal bf16: K1 {res['ms']:.4f} ms "
                  f"({tf / res['ms']:.1f} TFLOP/s), plain version {res['plain_ms']:.4f} ms "
                  f"({tf / res['plain_ms']:.1f} TFLOP/s), bound {res['bound_ms']:.4f} ms, SDPA "
                  f"{res['library_ms']:.4f} ms (median CUDA-event time)")
    return res


def phase_bwd_check() -> dict:
    """K3 against bwd_reference on f32 copies of the same bf16 inputs, with
    the same LSE and Delta (from the f32 forward). Budget BWD_TOL[bf16] per
    element on dQ, dK and dV: the kernel feeds P and dS to the tensor cores
    in bf16, and its dQ atomics sum in an order that changes from run to run."""
    from flashattn_tpu_torch.ops import flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.utils.testing import BWD_TOL, grad_gate, make_qkv
    from flashattn_tpu_torch.utils.timing import attention_flops

    tol = BWD_TOL[torch.bfloat16]
    # (name, B, Hq, Hkv, Nq, Nk, D, causal, kv_valid_len)
    cases = [(c[0], *c[1:], causal, None) for c in CAUSAL_CASES for causal in (True, False)]
    cases += [("unet", 1, 8, 8, 4096, 4096, 40, False, None),
              ("GQA-16/8", 1, 16, 8, 1024, 1024, 128, False, None),
              ("kv-tail", 1, 8, 2, 1000, 1100, 64, False, 1000)]
    res = None
    for i, (name, B, Hq, Hkv, Nq, Nk, D, causal, kvl) in enumerate(cases):
        q, k, v = (_bnhd(x) for x in make_qkv(300 + i, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv,
                                               dtype=torch.bfloat16, device=DEVICE))
        do = _bnhd(make_qkv(400 + i, B, Hq, Nq, D, dtype=torch.bfloat16, device=DEVICE)[0])
        scale = D ** -0.5
        o32, lse = flash_fwd.fwd_reference(q.float(), k.float(), v.float(), scale=scale,
                                           causal=causal, kv_valid_len=kvl)
        delta = (do.float() * o32).sum(-1)
        got = flash_bwd_fused.bwd(q, k, v, do, lse, delta, scale=scale, causal=causal,
                                  kv_valid_len=kvl)
        torch.cuda.synchronize()
        want = flash_bwd_fused.bwd_reference(q.float(), k.float(), v.float(), do.float(), lse,
                                             delta, scale=scale, causal=causal, kv_valid_len=kvl)
        ok, why, gmd, _ = grad_gate(got, want, tol)
        log("kernel", f"K3 {name} B{B} Hq{Hq} Hkv{Hkv} Nq{Nq} Nk{Nk} D{D} "
                      f"{'causal' if causal else 'non-causal'}"
                      f"{'' if kvl is None else f' kv_valid_len {kvl}'}: dQ/dK/dV max_abs_err "
                      f"{gmd:.3e} (budget BWD_TOL[bf16] atol {tol.atol} rtol {tol.rtol})")
        if not ok:
            fail(f"K3 disagrees with bwd_reference at {name} causal={causal}: {why}")
        if name == "lm" and causal:
            res = {"max_abs_err": gmd}
            args = (q, k, v, do, lse, delta)
    B, Hq, Hkv, N, _, D = CAUSAL_CASES[0][1:]
    res["ms"] = cuda_ms(lambda: flash_bwd_fused.bwd(*args, scale=D ** -0.5, causal=True))
    res["plain_ms"] = cuda_ms(lambda: flash_bwd_fused.bwd_reference(
        *args, scale=D ** -0.5, causal=True), reps=5)
    tf = attention_flops(B, Hq, N, N, D, causal=True, mode="bwd") / 1e9
    q, k, v, do = args[:4]
    # In: q, k, v, dO (bf16), LSE, Delta (f32); out: dQ, and dK/dV per q head (f32).
    res.update(bound(tensor_bytes(q, k, v, do, *args[4:]) + 4 * (q.numel() + 2 * Hq * N * D),
                     tf * 1e9))
    res["library_ms"] = sdpa_ms(q, k, v, do=do, is_causal=True)
    res["library_call"] = "the backward of scaled_dot_product_attention(is_causal=True)"
    log("kernel", f"lm shape B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal bf16: K3 {res['ms']:.4f} ms "
                  f"({tf / res['ms']:.1f} TFLOP/s), plain version {res['plain_ms']:.4f} ms "
                  f"({tf / res['plain_ms']:.1f} TFLOP/s), bound {res['bound_ms']:.4f} ms, SDPA "
                  f"backward {res['library_ms']:.4f} ms (median CUDA-event time)")
    return res


def packed_ids(B: int, n_tokens: int, docs: int = 8) -> torch.Tensor:
    """benchmarks/bench_lm.py:66-69: ``docs`` equal documents per row of
    ``n_tokens`` tokens (the last one shorter), int32 ``[B, n_tokens]``."""
    ids = torch.arange(docs, dtype=torch.int32, device=DEVICE).repeat_interleave(
        (n_tokens + docs - 1) // docs)[:n_tokens]
    return ids[None].expand(B, n_tokens).contiguous()


def random_ids(seed: int, B: int, N: int, n_segs: int = 4) -> torch.Tensor:
    """benchmarks/spot_segments.py:34-36: a document boundary after each token
    with probability ``n_segs / N``, int32 ``[B, N]``."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    bounds = torch.rand((B, N), generator=gen, device=DEVICE) < n_segs / N
    return torch.cumsum(bounds.int(), dim=1, dtype=torch.int32)


# (name, B, Hq, Hkv, Nq, Nk, D, causal, ids): bench_lm's packed cell, random
# boundaries at an unaligned N (causal and not), GQA, (q_ids, kv_ids) with
# Nq != Nk, and the dead rows of tests/test_segments.py:116-141 (query rows
# of a segment that no key carries).
SEG_CASES = [("packed", 2, 16, 8, 4096, 4096, 128, True, "packed"),
             ("N1537", 2, 8, 8, 1537, 1537, 64, True, "random"),
             ("N1537", 2, 8, 8, 1537, 1537, 64, False, "random"),
             ("GQA-16/4", 1, 16, 4, 1024, 1024, 128, True, "random"),
             ("Nq777-Nk1300", 2, 8, 8, 777, 1300, 64, False, "tuple"),
             ("dead-rows", 1, 8, 8, 1024, 1024, 128, False, "dead")]


def _seg_case_ids(kind: str, seed: int, B: int, Nq: int, Nk: int):
    if kind == "packed":
        ids = packed_ids(B, Nq + 1)[:, :Nq]  # the LM's forward sees tokens[:, :-1]
        return ids, ids
    if kind == "random":
        ids = random_ids(seed, B, Nq)
        return ids, ids
    if kind == "tuple":
        return random_ids(seed, B, Nq), random_ids(seed + 1, B, Nk)
    seg_q = torch.zeros((B, Nq), dtype=torch.int32, device=DEVICE)
    seg_q[:, Nq // 2:] = 7
    return seg_q, torch.zeros((B, Nk), dtype=torch.int32, device=DEVICE)


def phase_seg_check() -> dict:
    """K1 with segments, K5 and K6 against their plain versions on f32 copies
    of the same bf16 inputs (K5/K6 with the LSE and Delta of the f32
    forward): O within FWD_TOL[bf16], LSE within 1e-3 on live rows, dQ/dK/dV
    within BWD_TOL[bf16]; the dead rows' O and dQ exactly 0. Times each kernel
    at bench_lm's packed shape beside its plain version, and prints, ungated,
    K1 with segments against K1 causal there and K5 + K6 against K3 at the
    unpacked "lm" shape."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import (
        BWD_TOL, FWD_TOL, Tolerance, check_close, grad_gate, make_qkv)

    o_tol, lse_tol, g_tol = FWD_TOL[torch.bfloat16], Tolerance(LSE_ATOL, 0.0), BWD_TOL[torch.bfloat16]
    res = {}
    for i, (name, B, Hq, Hkv, Nq, Nk, D, causal, kind) in enumerate(SEG_CASES):
        q, k, v = (_bnhd(x) for x in make_qkv(500 + i, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv,
                                               dtype=torch.bfloat16, device=DEVICE))
        do = _bnhd(make_qkv(600 + i, B, Hq, Nq, D, dtype=torch.bfloat16, device=DEVICE)[0])
        kw = dict(scale=D ** -0.5, causal=causal, segment_ids=_seg_case_ids(kind, 700 + i, B, Nq, Nk))
        o, lse = flash_fwd.fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        f32 = [x.float() for x in (q, k, v, do)]
        o_want, lse_want = flash_fwd.fwd_reference(*f32[:3], **kw)
        live = lse_want > math.log(2.0) * DEFAULT_MASK_VALUE * 0.5
        ok_o, msg_o = check_close(o, o_want, o_tol, "O")
        ok_l, msg_l = check_close(lse[live], lse_want[live], lse_tol, "LSE")
        err1 = (o.float() - o_want).abs().max().item()
        delta = (f32[3] * o_want.float()).sum(-1)
        args = (q, k, v, do, lse_want, delta)
        dk, dv = flash_bwd.dkv(*args, **kw)
        dq = flash_bwd.dq(*args, **kw)
        torch.cuda.synchronize()
        ok5, why5, err5, _ = grad_gate((dk, dv), flash_bwd.dkv_reference(
            *f32, lse_want, delta, **kw), g_tol, names=("dk", "dv"))
        ok6, why6, err6, _ = grad_gate((dq,), (flash_bwd.dq_reference(
            *f32, lse_want, delta, **kw),), g_tol, names=("dq",))
        dead = ~live
        dead_zero = bool((o[dead] == 0).all() and (dq[dead] == 0).all())
        log("seg", f"{name} B{B} Hq{Hq} Hkv{Hkv} Nq{Nq} Nk{Nk} D{D} "
                   f"{'causal' if causal else 'non-causal'} {kind} ids: K1 O max_abs_err "
                   f"{err1:.3e} (budget {O_TOL_NAME}), LSE live rows max_abs_err "
                   f"{(lse[live] - lse_want[live]).abs().max().item():.3e} (budget {LSE_ATOL}); "
                   f"K5 dK/dV {err5:.3e}, K6 dQ {err6:.3e} (budget BWD_TOL[bf16] atol "
                   f"{g_tol.atol} rtol {g_tol.rtol}); dead rows {int(dead.sum())}, their O "
                   f"and dQ exactly 0: {dead_zero}")
        if not (ok_o and ok_l):
            fail(f"K1 with segments disagrees with fwd_reference at {name}: {msg_o}; {msg_l}")
        if not (ok5 and ok6):
            fail(f"K5/K6 disagree with their plain versions at {name}: {why5}; {why6}")
        if not dead_zero:
            fail(f"dead rows at {name}: O or dQ not exactly 0")
        if kind == "dead" and not dead.any():
            fail("the dead-row case has no dead row")
        if name == "packed":
            res = {"k1": {"max_abs_err": err1}, "k5": {"max_abs_err": err5},
                   "k6": {"max_abs_err": err6}}
            packed = (q, k, v, do, lse_want, delta, kw)

    q, k, v, do, lse_want, delta, kw = packed
    args = (q, k, v, do, lse_want, delta)
    B, Hq, Hkv, N, _, D = SEG_CASES[0][1:7]
    timed = {"k1": (lambda: flash_fwd.fwd(q, k, v, **kw),
                    lambda: flash_fwd.fwd_reference(q, k, v, **kw)),
             "k5": (lambda: flash_bwd.dkv(*args, **kw),
                    lambda: flash_bwd.dkv_reference(*args, **kw)),
             "k6": (lambda: flash_bwd.dq(*args, **kw),
                    lambda: flash_bwd.dq_reference(*args, **kw))}
    for key, (kernel, plain) in timed.items():
        res[key]["ms"] = cuda_ms(kernel)
        res[key]["plain_ms"] = cuda_ms(plain, reps=3)
    mask = dict(kv_valid_len=N, causal=True, segment_ids=kw["segment_ids"])
    ids = tensor_bytes(*kw["segment_ids"])
    stats = 4 * B * Hq * N  # one f32 per row: LSE or Delta
    grad = 4 * B * Hq * N * D  # one f32 gradient of q's shape
    res["k1"].update(bound(tensor_bytes(q, k, v, q) + stats + ids,
                           pair_flops(q, k, matmuls=2, **mask)))
    res["k5"].update(bound(tensor_bytes(q, k, v, do) + 2 * stats + ids + 2 * grad,
                           pair_flops(q, k, matmuls=4, **mask)))
    res["k6"].update(bound(tensor_bytes(q, k, v, do) + 2 * stats + ids + grad,
                           pair_flops(q, k, matmuls=3, **mask)))
    docs = band_mod(None, kw["segment_ids"][0])
    res["k1"].update(library_ms=flex_ms(q, k, v, scale=kw["scale"], mask_mod=docs),
                     library_call="flex_attention (torch.compile) with the causal document mask")
    bwd_ms = flex_ms(q, k, v, scale=kw["scale"], do=do, mask_mod=docs)
    for key in ("k5", "k6"):
        res[key].update(library_ms=bwd_ms, library_call=(
            "the backward of flex_attention (torch.compile) with the causal document mask "
            "(dQ, dK and dV in one call)"))
    causal_ms = cuda_ms(lambda: flash_fwd.fwd(q, k, v, scale=kw["scale"], causal=True))
    log("seg", f"packed shape B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal, 8 documents per row, bf16: "
               f"K1 with segments {res['k1']['ms']:.4f} ms (plain {res['k1']['plain_ms']:.4f}), "
               f"K5 {res['k5']['ms']:.4f} ms (plain {res['k5']['plain_ms']:.4f}), "
               f"K6 {res['k6']['ms']:.4f} ms (plain {res['k6']['plain_ms']:.4f}); "
               f"flex_attention {res['k1']['library_ms']:.4f} ms, its backward "
               f"{bwd_ms:.4f} ms (median CUDA-event time)")
    log("seg", f"not gated: K1 causal without segments at the same shape {causal_ms:.4f} ms; "
               f"K1 with segments / K1 causal = {res['k1']['ms'] / causal_ms:.3f}")

    B, Hq, Hkv, N, _, D = CAUSAL_CASES[0][1:]
    q, k, v = (_bnhd(x) for x in make_qkv(800, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                           device=DEVICE))
    do = _bnhd(make_qkv(801, B, Hq, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    o32, lse = flash_fwd.fwd_reference(q.float(), k.float(), v.float(), scale=D ** -0.5,
                                       causal=True)
    args = (q, k, v, do, lse, (do.float() * o32).sum(-1))
    kw = dict(scale=D ** -0.5, causal=True)
    k3_ms = cuda_ms(lambda: flash_bwd_fused.bwd(*args, **kw))
    k5_ms = cuda_ms(lambda: flash_bwd.dkv(*args, **kw))
    k6_ms = cuda_ms(lambda: flash_bwd.dq(*args, **kw))
    log("seg", f"not gated: lm shape B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal, no segments: K3 "
               f"{k3_ms:.4f} ms, K5 + K6 {k5_ms:.4f} + {k6_ms:.4f} = {k5_ms + k6_ms:.4f} ms "
               f"({(k5_ms + k6_ms) / k3_ms:.3f}x K3: the deterministic two-pass dQ)")
    return res


def phase_slice() -> int:
    from flashattn_tpu_torch.models.diffusion import euler_sample
    from flashattn_tpu_torch.models.unet import UNetConfig, init_unet, unet_forward
    from flashattn_tpu_torch.ops import flash_fwd

    # zero_init=False: with SD's zero-init, proj_out and conv_out are zero and
    # attention could not change the output, so the comparison would prove nothing.
    cfg = dataclasses.replace(UNetConfig.sd15(), zero_init=False)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    unet = init_unet(cfg, gen, device=DEVICE)
    n_params = sum(p.numel() for p in unet.parameters())
    shape = (1, LATENT, LATENT, cfg.in_channels)
    x = torch.randn(shape, generator=gen, device=DEVICE)
    ctx = torch.randn((1, CONTEXT_LEN, cfg.context_dim), generator=gen, device=DEVICE)
    t = torch.full((1,), 500.0, device=DEVICE)
    with torch.no_grad():
        eps = {arm: unet_forward(unet, x, t, ctx, cfg, attn_impl=arm) for arm in ("fused", "xla")}
    torch.cuda.synchronize()
    for arm, e in eps.items():
        if e.shape != shape or not torch.isfinite(e).all():
            fail(f"U-Net forward ({arm}) gave shape {tuple(e.shape)} or non-finite values")
    rel = ((eps["fused"] - eps["xla"]).norm() / eps["xla"].norm()).item()
    log("slice", f"SD1.5 U-Net ({n_params / 1e6:.1f} M params, bf16) forward at "
                 f"{LATENT}x{LATENT}: fused vs xla relative L2 error {rel:.3e} "
                 f"(limit {REL_L2_LIMIT})")
    if not rel <= REL_L2_LIMIT:
        fail(f"fused and xla U-Net forwards differ: relative L2 {rel:.3e} > {REL_L2_LIMIT}")

    # Two requests, each with its own seed and context; made before the timed runs.
    requests = []
    for seed in (1, 2):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        requests.append((torch.randn((1, CONTEXT_LEN, cfg.context_dim), generator=g, device=DEVICE),
                         torch.randn(shape, generator=g, device=DEVICE)))
    per_forward = predicted_fused_calls(cfg, LATENT, LATENT, CONTEXT_LEN)
    expected = per_forward * STEPS * REQUESTS
    launches = None
    for arm in ("fused", "xla"):
        if arm == "fused":
            flash_fwd.fwd.launches = 0
        secs = []
        for ctx_r, noise_r in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lat = euler_sample(unet, ctx_r, cfg=cfg, shape=shape, steps=STEPS, noise=noise_r,
                               attn_impl=arm)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if lat.shape != shape or not torch.isfinite(lat).all():
                fail(f"{arm} sample is not finite or has shape {tuple(lat.shape)}")
        if arm == "fused":
            launches = flash_fwd.fwd.launches
        s_req = statistics.mean(secs)
        log("slice", f"{arm}: {REQUESTS} requests x {STEPS} Euler steps, "
                     f"{s_req:.4f} s/request ({', '.join(f'{s:.4f}' for s in secs)}), "
                     f"{STEPS / s_req:.2f} it/s, latents finite")
    log("slice", f"K1 launches during the fused requests: {launches} (expected "
                 f"{per_forward} per forward from _exact_is_faster x {STEPS} steps x "
                 f"{REQUESTS} requests = {expected})")
    if launches != expected:
        fail(f"K1 launched {launches} times on the main path, expected {expected}")
    return launches


def _rel_l2(a: dict, b: dict) -> float:
    """Relative L2 distance of two gradient dicts, as one concatenated vector."""
    num = sum((a[n].float() - b[n].float()).pow(2).sum().item() for n in b)
    den = sum(b[n].float().pow(2).sum().item() for n in b)
    return math.sqrt(num / den)


def _lm_gates(cfg, tokens, segment_ids, grad_limit: float | None, phase: str) -> None:
    """Loss and gradient gates of the LM, fused against xla on the same
    weights and tokens: the loss within bench_lm.py's rule, the gradients
    within ``grad_limit`` relative L2 (None: 1.5x the bf16 noise floor of
    this run), with the bf16 noise floor (each arm against an f32 copy of the
    model) printed beside it."""
    from flashattn_tpu_torch.models.transformer import Transformer, init_transformer, lm_loss

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = init_transformer(cfg, gen, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())

    def loss_and_grads(m, arm):
        m.zero_grad(set_to_none=True)
        loss = lm_loss(m, tokens, m.cfg, attn_impl=arm, segment_ids=segment_ids)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in m.named_parameters()}

    lf, gf = loss_and_grads(model, "fused")
    lx, gx = loss_and_grads(model, "xla")
    m32 = Transformer(dataclasses.replace(cfg, dtype=torch.float32), device=DEVICE)
    m32.load_state_dict(model.state_dict())
    l32, g32 = loss_and_grads(m32, "xla")
    del m32
    for arm, loss, g in (("fused", lf, gf), ("xla", lx, gx)):
        if not math.isfinite(loss) or not all(torch.isfinite(t).all() for t in g.values()):
            fail(f"LM {arm}: loss {loss} or its gradients are not finite")
    docs = "" if segment_ids is None else f" in {int(segment_ids.max()) + 1} documents"
    opts = "".join(f", {n} {getattr(cfg, n)}" for n in ("sliding_window", "logit_softcap")
                   if getattr(cfg, n) is not None)
    loss_limit = max(5e-2, 1e-2 * abs(lx))
    log(phase, f"LM ({n_params / 1e6:.1f} M params, {cfg.n_layers} layers, d_model "
               f"{cfg.d_model}, Hq{cfg.n_heads} Hkv{cfg.n_kv_heads} D{cfg.d_head}, bf16{opts}) on "
               f"{list(tokens.shape)} tokens{docs}: loss fused {lf:.5f}, xla {lx:.5f}, f32 model "
               f"{l32:.5f}; |fused - xla| {abs(lf - lx):.2e} (limit {loss_limit:.2e}, "
               f"bench_lm.py's rule)")
    if not abs(lf - lx) < loss_limit:
        fail(f"LM loss gate ({phase}): fused {lf} vs xla {lx}")
    floor = max(_rel_l2(gf, g32), _rel_l2(gx, g32))
    rel = _rel_l2(gf, gx)
    if grad_limit is None:
        grad_limit = 1.5 * floor
    log(phase, f"gradients: fused vs xla relative L2 {rel:.3e} (limit {grad_limit:.4e}); "
               f"bf16 noise floor {floor:.3e} (fused vs f32 model {_rel_l2(gf, g32):.3e}, "
               f"xla vs f32 model {_rel_l2(gx, g32):.3e})")
    if not rel <= grad_limit:
        fail(f"LM gradient gate ({phase}): fused vs xla relative L2 {rel:.3e} > {grad_limit}")
    del model, gf, gx, g32
    torch.cuda.empty_cache()


def _lm_steps(cfg, tokens, arm: str, segment_ids=None, *, phase: str, label: str,
              steps: int = LM_STEPS, warmup: int = LM_WARMUP) -> float:
    """``steps`` AdamW steps from the seed-0 weights; logs ms/step (median
    after ``warmup`` warm-up steps), tokens/s, peak GB and the losses, fails
    unless the losses are finite and falling, and returns s/step."""
    from flashattn_tpu_torch.models.transformer import (
        adamw_init, adamw_update, init_transformer, lm_loss)

    model = init_transformer(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        loss = lm_loss(model, tokens, cfg, attn_impl=arm, segment_ids=segment_ids)
        loss.backward()
        adamw_update({n: p.grad for n, p in params.items()}, opt, params)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(secs[warmup:])
    n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
    log(phase, f"{label}: {steps} AdamW steps on {list(tokens.shape)} tokens, "
               f"{step_s * 1e3:.2f} ms/step ({', '.join(f'{s * 1e3:.1f}' for s in secs)}), "
               f"{n_tokens / step_s:.0f} tokens/s (median after {warmup} warm-up steps), "
               f"peak {peak:.2f} GB; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"LM {label} training: losses {losses} not finite or not falling")
    del model, params, opt
    torch.cuda.empty_cache()
    return step_s


def _reset_launches() -> None:
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd, gemm, roofline

    flash_fwd.fwd.launches = flash_bwd_fused.bwd.launches = 0
    flash_fwd.fwd.launches_bias = flash_fwd.fwd.launches_int8 = flash_fwd.fwd.launches_fp8 = 0
    flash_fwd.fwd.launches_window = flash_fwd.fwd.launches_softcap = 0
    flash_bwd.dkv.launches = flash_bwd.dq.launches = 0
    flash_bwd.dkv.launches_bias = flash_bwd.dq.launches_bias = flash_bwd.dq.launches_dbias = 0
    gemm.matmul.launches = roofline.roofline_call.launches = 0


def _launches() -> dict:
    """Every kernel's launch count; "K1" counts all K1 launches, "K1 bias",
    "K1 int8", "K1 fp8", "K1 window" and "K1 softcap" those of its variants
    (a launch with a window and a softcap counts in both); "K5 bias" and "K6
    bias" the K5 / K6 launches with a bias, "K6 dbias" those that also wrote
    dbias."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd, gemm, roofline

    return {"K1": flash_fwd.fwd.launches, "K1 bias": flash_fwd.fwd.launches_bias,
            "K1 int8": flash_fwd.fwd.launches_int8, "K1 fp8": flash_fwd.fwd.launches_fp8,
            "K1 window": flash_fwd.fwd.launches_window,
            "K1 softcap": flash_fwd.fwd.launches_softcap,
            "K3": flash_bwd_fused.bwd.launches, "K5": flash_bwd.dkv.launches,
            "K5 bias": flash_bwd.dkv.launches_bias, "K6": flash_bwd.dq.launches,
            "K6 bias": flash_bwd.dq.launches_bias, "K6 dbias": flash_bwd.dq.launches_dbias,
            "K9": gemm.matmul.launches, "K10": roofline.roofline_call.launches}


def _expect(**counts) -> dict:
    """A launch-count dict with every kernel not named at 0."""
    return {**dict.fromkeys(_launches(), 0), **{k.replace("_", " "): v for k, v in counts.items()}}


def phase_train() -> tuple[int, int]:
    from flashattn_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(**LM_WIDTH)  # bf16
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_SEQ + 1), generator=gen, device=DEVICE)
    _lm_gates(cfg, tokens, None, GRAD_REL_L2_LIMIT, "train")
    _reset_launches()
    _lm_steps(cfg, tokens, "fused", phase="train", label="fused")
    counts = _launches()
    _lm_steps(cfg, tokens, "xla", phase="train", label="xla")
    expected = cfg.n_layers * LM_STEPS
    log("train", f"launches during the fused steps: {counts} (expected K1 = K3 = "
                 f"{cfg.n_layers} layers x {LM_STEPS} steps = {expected}, no other)")
    if counts != _expect(K1=expected, K3=expected):
        fail(f"LM steps launched {counts}, expected K1 = K3 = {expected} and no other")
    return counts["K1"], counts["K3"]


def phase_packed_train() -> dict:
    """Packed-sequence training (bench_lm.py's packed cell): loss and
    gradient gates at [1, 2049] tokens in 8 documents, fused vs xla; then
    LM_STEPS fused AdamW steps at [2, 4097] tokens, 8 documents per row, with
    exact launch counts, and the unpacked fused step at the same shape (the
    segment-masking overhead column). The xla arm is skipped at N4096, as
    bench_lm.py:130-134 skips it (its f32 scores would take ~34 GB)."""
    from flashattn_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(**LM_WIDTH)  # bf16
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_SEQ + 1), generator=gen, device=DEVICE)
    _lm_gates(cfg, tokens, packed_ids(1, LM_SEQ + 1), PACKED_GRAD_REL_L2_LIMIT, "packed")

    B, N = PACKED_SHAPE
    tokens = torch.randint(0, cfg.vocab_size, (B, N + 1), generator=gen, device=DEVICE)
    _reset_launches()
    packed_s = _lm_steps(cfg, tokens, "fused", packed_ids(B, N + 1), phase="packed",
                         label="fused, 8 documents per row")
    counts = _launches()
    plain_s = _lm_steps(cfg, tokens, "fused", phase="packed", label="fused, unpacked")
    expected = cfg.n_layers * LM_STEPS
    log("packed", f"packed step / unpacked step at [{B}, {N + 1}]: {packed_s / plain_s:.3f}")
    log("packed", f"launches during the packed fused steps: {counts} (expected K1 = K5 = K6 = "
                  f"{cfg.n_layers} layers x {LM_STEPS} steps = {expected}, no other)")
    if counts != _expect(K1=expected, K5=expected, K6=expected):
        fail(f"packed LM steps launched {counts}, expected K1 = K5 = K6 = {expected} and no "
             "other")
    return counts


# bench_decode.py:124-138: decode attention, B8 H16 D128 against an 8192-slot
# cache; the Hkv < 16 cases run GQA-folded.
DECODE_B, DECODE_H, DECODE_NK, DECODE_D = 8, 16, 8192, 128
KV_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _decode_slot_bias(nk: int, live: int) -> torch.Tensor:
    """decode_step's cache-slot mask: ``[1, 1, 1, nk]`` f32, -1e9 past ``live``."""
    slot = torch.arange(nk, device=DEVICE)
    return torch.where(slot < live, 0.0, -1e9).to(torch.float32)[None, None, None]


def phase_decode_check() -> dict:
    """K1's decode variants -- bias on bf16 K/V, int8 and fp8 K/V with and
    without bias -- against their plain version on the dequantized cache, at
    bench_decode's attention shapes (Hkv 16, 8, 4, 2 with a cache-slot bias
    of half the slots live, Nq 1, GQA-folded where Hkv < 16; Nq 16 without
    bias) and a random [B, H, Nq, Nk] bias at B2 H4 Nq1000 Nk1100 D64
    causal: O within FWD_TOL[bf16]. Times each case's kernel launch (on the
    folded shape the path gives it) and its plain version, with the KV read
    rate 2·B·Hkv·Nk·D·bytes / t of bench_decode.py:94."""
    from flashattn_tpu_torch.ops import flash_fwd, quant
    from flashattn_tpu_torch.ops.flash import flash_attention
    from flashattn_tpu_torch.utils.testing import FWD_TOL, check_close, make_qkv

    tol = FWD_TOL[torch.bfloat16]
    B, H, Nk, D = DECODE_B, DECODE_H, DECODE_NK, DECODE_D
    # (B, Hq, Hkv, Nq, Nk, D, bias, causal)
    cases = [(B, H, hkv, 1, Nk, D, "slots", False) for hkv in (16, 8, 4, 2)]
    cases += [(B, H, H, 16, Nk, D, None, False), (2, 4, 4, 1000, 1100, 64, "random", True)]
    res = {}
    for i, (b, hq, hkv, nq, nk, d, bias_kind, causal) in enumerate(cases):
        q, k, v = make_qkv(900 + i, b, hq, nq, d, Nk=nk, Hkv=hkv, dtype=torch.bfloat16,
                           device=DEVICE)
        bias = None
        if bias_kind == "slots":
            bias = _decode_slot_bias(nk, nk // 2)
        elif bias_kind == "random":
            gen = torch.Generator(device=DEVICE).manual_seed(950 + i)
            bias = torch.randn((b, hq, nq, nk), generator=gen, device=DEVICE)
        rep = hq // hkv
        folded = rep > 1 and not causal and nq * rep <= 32
        for name, dtype in KV_DTYPES.items():
            kw = dict(scale=d ** -0.5, causal=causal, bias=bias)
            if dtype == torch.bfloat16:
                o = flash_attention(q, k, v, bias=bias, causal=causal)
                kk, vv, scales = k, v, {}
            else:
                qkv = quant.quantize_kv(k, v, dtype, allow_slow_fp8=True)
                o = quant.flash_attention_quantized(q, qkv, bias=bias, causal=causal)
                kk, vv = qkv.k_q, qkv.v_q
                scales = dict(k_scale=qkv.k_scale, v_scale=qkv.v_scale)
            torch.cuda.synchronize()
            o_want, _ = flash_fwd.fwd_reference(q.float(), kk, vv, **kw, **scales)
            ok, msg = check_close(o, o_want, tol, "O")
            err = (o.float() - o_want).abs().max().item()
            # The launch the path makes: the folded query for tiny-Nq GQA.
            qk = q.reshape(b, hkv, rep * nq, d) if folded else q
            if bias is not None and folded and bias.shape[2] > 1:
                kw["bias"] = bias.repeat(1, 1, rep, 1)
            ms = cuda_ms(lambda: flash_fwd.fwd(qk, kk, vv, **kw, **scales))
            plain_ms = cuda_ms(lambda: flash_fwd.fwd_reference(q, kk, vv, **kw, **scales),
                               reps=3, trials=3)
            nbytes = 2 * b * hkv * nk * d * kk.element_size()
            label = (f"{name} B{b} Hq{hq} Hkv{hkv} Nq{nq} Nk{nk} D{d}"
                     f"{' causal' if causal else ''}"
                     f"{'' if bias_kind is None else f' bias {bias_kind}'}"
                     f"{' folded' if folded else ''}")
            log("decode", f"{label}: O max_abs_err {err:.3e} (budget {O_TOL_NAME}); K1 "
                          f"{ms * 1e3:.2f} us ({nbytes / ms / 1e6:.1f} GB/s KV read), plain "
                          f"{plain_ms * 1e3:.2f} us ({nbytes / plain_ms / 1e6:.1f} GB/s)")
            if not ok:
                fail(f"K1 ({label}) disagrees with fwd_reference: {msg}")
            if (hkv, nq, bias_kind) == (8, 1, "slots"):  # the LM's decode attention
                res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound(
                    tensor_bytes(q, kk, vv, bias, q, *scales.values()) + 4 * b * hq * nq,
                    4.0 * d * b * hq * nq * nk)}
                if dtype == torch.bfloat16:
                    res[name]["library_ms"] = sdpa_ms(q, k, v, attn_mask=bias)
                    res[name]["library_call"] = ("scaled_dot_product_attention(attn_mask=bias, "
                                                 "enable_gqa=True)")
                else:
                    res[name].update(library_ms=None, library_call=(
                        "none: no PyTorch call takes int8 / fp8 K/V with per-token scales"))
        del q, k, v, kk, vv, scales
        torch.cuda.empty_cache()
    return res


# benchmarks/bench_decode.py:115-118: the LM bench_decode serves, full depth.
DECODE_WIDTH = dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
                    d_head=128, d_ff=5632)
DECODE_GATE_TOKENS = 32
DECODE_REQUESTS, PROMPT_LEN, GEN_LEN = 8, 64, 64
DECODE_CACHE_LENS = (1024, 4096, 8192)
DECODE_STEPS, DECODE_WARMUP = 10, 3
# Quantized cache against the bf16 cache: max|dlogits| < rule x max(max|logits|, 1).
# int8 takes the JAX rule (tests/test_models.py:134-147). e4m3 keeps 3
# mantissa bits, so each element rounds by up to 2^-4 of itself, where int8
# rounds by 1/254 of the token's amax: at this LM fp8 measured 2.73x int8's
# deviation (max|dlogits| 0.3203 vs 0.1172, relative L2 6.49e-2 vs 2.36e-2,
# H100), above the JAX rule, so its limit is 3x the rule.
QUANT_RULE = {"int8": 0.05, "fp8": 0.15}


def _decode_logits(model, cfg, tokens, quant_dtype=None):
    """Decode logits ``[B, T, V]`` of feeding ``tokens [B, T]`` one by one."""
    from flashattn_tpu_torch.models.transformer import decode_step, init_kv_cache

    cache = init_kv_cache(cfg, tokens.shape[0], tokens.shape[1], quant_dtype, device=DEVICE)
    return torch.stack([decode_step(model, cache, tokens[:, t], cfg)[0]
                        for t in range(tokens.shape[1])], dim=1)


def _decode_gate(model, cfg, tokens, phase: str) -> torch.Tensor:
    """Decode logits of a bf16 cache against the fused teacher-forced forward
    at the same positions: relative L2 within 1.5x the bf16 floor (each of
    the two against an f32 copy of the model with exact attention), measured
    and printed here. Returns the decode logits."""
    from flashattn_tpu_torch.models.transformer import Transformer, transformer_forward

    with torch.no_grad():
        fwd = transformer_forward(model, tokens, cfg)
        m32 = Transformer(dataclasses.replace(cfg, dtype=torch.float32), device=DEVICE)
        m32.load_state_dict(model.state_dict())
        ref = transformer_forward(m32, tokens, m32.cfg, attn_impl="xla")
        del m32
    dec = _decode_logits(model, cfg, tokens)
    torch.cuda.synchronize()
    if dec.shape != fwd.shape or not torch.isfinite(dec).all():
        fail(f"{phase}: decode logits have shape {tuple(dec.shape)} or are not finite")
    floor = max(_rel(dec, ref), _rel(fwd, ref))
    rel = _rel(dec, fwd)
    n_params = sum(p.numel() for p in model.parameters())
    opts = "".join(f", {n} {getattr(cfg, n)}" for n in ("sliding_window", "logit_softcap")
                   if getattr(cfg, n) is not None)
    log(phase, f"LM ({n_params / 1e6:.1f} M params, {cfg.n_layers} layers, d_model "
               f"{cfg.d_model}, Hq{cfg.n_heads} Hkv{cfg.n_kv_heads} D{cfg.d_head}, bf16{opts}), "
               f"{list(tokens.shape)} tokens: bf16-cache decode vs teacher-forced forward "
               f"relative L2 {rel:.3e} (limit 1.5 x floor = {1.5 * floor:.3e}); bf16 floor "
               f"{floor:.3e} (decode vs f32 model {_rel(dec, ref):.3e}, forward vs "
               f"f32 model {_rel(fwd, ref):.3e})")
    if not rel <= 1.5 * floor:
        fail(f"{phase} decode gate: decode vs forward relative L2 {rel:.3e} > 1.5 x {floor:.3e}")
    return dec


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def phase_decode() -> dict:
    """The serving slice at bench_decode's width and depth (821 M params).

    Gates at batch 2 over the first 32 tokens: bf16-cache decode logits
    against the fused teacher-forced forward at the same positions, relative
    L2 within 1.5x the bf16 floor (each of the two against an f32 copy of the
    model, exact attention), measured and printed in every run; int8 and fp8
    caches against the bf16 cache by the JAX rule
    ``max|Δ| < 0.05·max(max|logits|, 1)``, 3x that for fp8 (QUANT_RULE).
    Then 8 requests at batch 8 per
    cache dtype (a 64-token prompt fed through decode_step, 64 greedy
    tokens), with exactly 16 K1 launches per step in the dtype's variant and
    no other kernel; then ms/token and tokens/s at cache lengths 1024, 4096
    and 8192 with the length held at half (bench_decode.py:46-55), batch 8,
    and the peak device memory. Returns the launch counts per dtype."""
    from flashattn_tpu_torch.models.transformer import (
        TransformerConfig, decode_step, init_kv_cache, init_transformer)
    from flashattn_tpu_torch.utils.platform import native_fp8_matmul

    cfg = TransformerConfig(**DECODE_WIDTH)  # bf16
    fp8_cache = init_kv_cache(cfg, 1, 1, torch.float8_e4m3fn, device=DEVICE)["k"][0].dtype
    log("decode", f"fp8 guard: native_fp8_matmul() = {native_fp8_matmul(DEVICE)}, "
                  f"init_kv_cache(float8_e4m3fn) stores {fp8_cache}")
    if fp8_cache != torch.float8_e4m3fn:
        fail(f"the fp8 guard turned an fp8 cache into {fp8_cache} on this card")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = init_transformer(cfg, gen, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, (2, DECODE_GATE_TOKENS), generator=gen,
                           device=DEVICE)
    dec = {"bf16": _decode_gate(model, cfg, tokens, "decode")}
    for name in ("int8", "fp8"):
        dec[name] = _decode_logits(model, cfg, tokens, KV_DTYPES[name])
        torch.cuda.synchronize()
        if dec[name].shape != dec["bf16"].shape or not torch.isfinite(dec[name]).all():
            fail(f"{name} decode logits have shape {tuple(dec[name].shape)} or are not finite")
    scale = max(dec["bf16"].abs().max().item(), 1.0)
    for name in ("int8", "fp8"):
        d = (dec[name] - dec["bf16"]).abs().max().item()
        limit = QUANT_RULE[name] * scale
        log("decode", f"{name} cache vs bf16 cache: max|dlogits| {d:.4f} (limit "
                      f"{QUANT_RULE[name]} x {scale:.4f} = {limit:.4f}), relative L2 "
                      f"{_rel(dec[name], dec['bf16']):.3e}")
        if not d < limit:
            fail(f"{name} cache decode differs from the bf16 cache's: {d} >= {limit}")
    del dec

    counts = {}
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (DECODE_REQUESTS, PROMPT_LEN), generator=gen,
                            device=DEVICE)
    steps = PROMPT_LEN + GEN_LEN
    for name, dt in KV_DTYPES.items():
        cache = init_kv_cache(cfg, DECODE_REQUESTS, steps, None if dt == torch.bfloat16 else dt,
                              device=DEVICE)
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        for t in range(PROMPT_LEN):
            logits, cache = decode_step(model, cache, prompts[:, t], cfg)
        out = []
        for _ in range(GEN_LEN):
            token = logits.argmax(-1)
            out.append(token)
            logits, cache = decode_step(model, cache, token, cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[name] = _launches()
        out = torch.stack(out, dim=1)
        if not torch.isfinite(logits).all() or not ((out >= 0) & (out < cfg.vocab_size)).all():
            fail(f"{name} requests: logits not finite or tokens out of range")
        variant = {"bf16": "K1_bias", "int8": "K1_int8", "fp8": "K1_fp8"}[name]
        want = _expect(K1=cfg.n_layers * steps, **{variant: cfg.n_layers * steps})
        log("decode", f"{name} cache: {DECODE_REQUESTS} requests at batch {DECODE_REQUESTS}, "
                      f"{PROMPT_LEN}-token prompt + {GEN_LEN} greedy tokens = {steps} steps in "
                      f"{secs:.3f} s ({secs / steps * 1e3:.2f} ms/step, "
                      f"{DECODE_REQUESTS * steps / secs:.0f} tokens/s); first request's tokens "
                      f"{out[0, :8].tolist()}...; launches {counts[name]} (expected "
                      f"{cfg.n_layers} x {steps} = {cfg.n_layers * steps} K1, all "
                      f"{variant.replace('_', ' ')})")
        if counts[name] != want:
            fail(f"{name} decode launched {counts[name]}, expected {want}")
        del cache
        torch.cuda.empty_cache()

    for cache_len in DECODE_CACHE_LENS:
        for name, dt in KV_DTYPES.items():
            _decode_ms(model, cfg, cache_len, None if dt == torch.bfloat16 else dt,
                       phase="decode", label=f"{name} cache")
    del model
    torch.cuda.empty_cache()
    return counts


def _decode_ms(model, cfg, cache_len: int, quant_dtype, *, phase: str, label: str) -> float:
    """bench_decode.py:46-55's method: ms/token of decode_step at batch
    DECODE_B against a ``cache_len``-slot cache with the length held at half,
    the median of DECODE_STEPS synchronised steps after DECODE_WARMUP;
    logs it with tokens/s and the peak device memory, returns s/token."""
    from flashattn_tpu_torch.models.transformer import decode_step, init_kv_cache

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = init_kv_cache(cfg, DECODE_B, cache_len, quant_dtype, device=DEVICE)
    cache["length"] = cache_len // 2
    token = torch.zeros(DECODE_B, dtype=torch.long, device=DEVICE)
    secs = []
    for i in range(DECODE_WARMUP + DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode_step(model, cache, token, cfg)
        token = logits.argmax(-1)
        cache["length"] -= 1  # hold the length, as bench_decode.py does
        torch.cuda.synchronize()
        if i >= DECODE_WARMUP:
            secs.append(time.perf_counter() - t0)
    step_s = statistics.median(secs)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(phase, f"{label}, cache_len {cache_len} (length {cache_len // 2}), batch "
               f"{DECODE_B}: {step_s * 1e3:.3f} ms/token ({min(secs) * 1e3:.3f}-"
               f"{max(secs) * 1e3:.3f}), {DECODE_B / step_s:.1f} tokens/s, peak "
               f"{peak:.2f} GB (median of {DECODE_STEPS} steps after {DECODE_WARMUP} warm-up)")
    del cache
    torch.cuda.empty_cache()
    return step_s


def band_ranges(n_outer: int, n_inner: int, outer: int, inner: int, lo, hi):
    """The inner rows a banded kernel visits for each ``outer``-row tile:
    ``(o0, begin, end)``, the ``inner``-aligned tiles from ``begin`` that meet
    the band [o0 - lo, o0 + outer - 1 + hi] (None: unbounded), up to ``end``
    -- the ranges that csrc/fwd_tile.cuh and dq_tile.cuh (Q tiles outer, KV
    tiles inner) and csrc/dkv_tile.cuh (KV tiles outer, with lo and hi
    swapped) compute, restated here only to print how many tile pairs they
    visit. Whether the kernels' own ranges hold the band is shown by
    phase_window_check's edge cases on the card."""
    for o0 in range(0, n_outer, outer):
        begin = 0 if lo is None else max(0, o0 - lo) // inner * inner
        end = n_inner if hi is None else min(n_inner, o0 + outer + hi)
        yield o0, begin, end


def band_tiles(n_outer: int, n_inner: int, outer: int, inner: int, lo, hi) -> int:
    """Tile pairs a banded kernel visits (:func:`band_ranges`)."""
    return sum(max(0, -(-(end - begin) // inner))
               for _, begin, end in band_ranges(n_outer, n_inner, outer, inner, lo, hi))


# (name, B, Hq, Hkv, Nq, Nk, D, causal, window): bench_lm's SWA attention
# (window 2047 = sliding_window 2048 - 1, causal), a non-causal local window,
# an unaligned left bound at an unaligned N, a right-only window with Nq > Nk,
# and a left bound with Nq > Nk (rows past Nk + 64 see no key: dead rows).
WINDOW_CASES = [("swa", 1, 16, 8, SWA_SEQ, SWA_SEQ, 128, True, (SWA_WINDOW - 1, -1)),
                ("local", 1, 16, 8, 2048, 2048, 128, False, (64, 64)),
                ("unaligned", 2, 8, 8, 1537, 1537, 64, True, (200, -1)),
                ("right-only", 1, 8, 8, 1300, 1024, 64, False, (-1, 50)),
                ("dead-rows", 1, 8, 8, 1300, 1024, 64, False, (64, -1))]


# The window checks draw q and k at GROW times unit variance: each row's
# softmax then peaks on a few keys and O, dQ, dK and dV are O(1), so that one
# pair dropped or added at a band edge moves an output by O(1). At unit
# variance a row spreads over its ~2048 keys, |O| is ~0.04, and such a fault
# stays inside FWD_TOL / BWD_TOL. Beside those per-element budgets each
# output's relative L2 error is held to WINDOW_REL_L2 (the bf16 rounding of
# P and dS gives ~2e-3 at the SWA shape).
GROW = 4
WINDOW_REL_L2 = 1e-2


def _grown(seed, B, Hq, Nq, D, Nk, Hkv):
    """q, k (scaled by GROW) and v, bf16 [B, H, N, D] views of [B, N, H, D]."""
    from flashattn_tpu_torch.utils.testing import make_qkv

    q, k, v = make_qkv(seed, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv, device=DEVICE)
    return tuple(_bnhd(x.to(torch.bfloat16)) for x in (GROW * q, GROW * k, v))


def _fwd_bwd_check(tag: str, q, k, v, do, *, phase: str = "window", want_dbias: bool = False,
                   **kw) -> dict:
    """K1 (flash_fwd.fwd) and its backward -- K3, or K5 + K6 with segment ids,
    a softcap or a bias, as flash_attention routes it, K6 also writing dbias
    with ``want_dbias`` -- against their plain versions on f32 copies of the
    same bf16 inputs: O within FWD_TOL[bf16], LSE within 1e-3 on live rows,
    dQ/dK/dV (and dbias) within BWD_TOL[bf16], each of O, dQ, dK, dV (and
    dbias) within WINDOW_REL_L2 relative L2 (printed with max|ref|), dead
    rows' O and dQ exactly 0. Returns the max errors, dbias, and the (q, k,
    v, do, lse, delta) the backward took."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import (
        BWD_TOL, FWD_TOL, Tolerance, check_close, grad_gate)

    o, lse = flash_fwd.fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    f32 = [x.float() for x in (q, k, v, do)]
    o_want, lse_want = flash_fwd.fwd_reference(*f32[:3], **kw)
    live = lse_want > math.log(2.0) * DEFAULT_MASK_VALUE * 0.5
    ok_o, msg_o = check_close(o, o_want, FWD_TOL[torch.bfloat16], "O")
    ok_l, msg_l = check_close(lse[live], lse_want[live], Tolerance(LSE_ATOL, 0.0), "LSE")
    err_o = (o.float() - o_want).abs().max().item()
    delta = (f32[3] * o_want.float()).sum(-1)
    args = (q, k, v, do, lse_want, delta)
    split = any(n in kw for n in ("softcap", "segment_ids", "bias"))
    if not split:
        got = flash_bwd_fused.bwd(*args, **kw)
        want = flash_bwd_fused.bwd_reference(*f32, lse_want, delta, **kw)
        names = ("dq", "dk", "dv")
    else:
        dq = flash_bwd.dq(*args, want_dbias=want_dbias, **kw)
        dq_want = flash_bwd.dq_reference(*f32, lse_want, delta, want_dbias=want_dbias, **kw)
        got = (*(dq if want_dbias else (dq,)), *flash_bwd.dkv(*args, **kw))
        want = (*(dq_want if want_dbias else (dq_want,)),
                *flash_bwd.dkv_reference(*f32, lse_want, delta, **kw))
        names = ("dq (K6)", *(("dbias (K6)",) if want_dbias else ()), "dk (K5)", "dv (K5)")
    torch.cuda.synchronize()
    g_tol = BWD_TOL[torch.bfloat16]
    ok_g, why_g, err_g, _ = grad_gate(got, want, g_tol, names=names)
    dead = ~live
    dead_zero = bool((o[dead] == 0).all() and (got[0][dead] == 0).all())
    rel = {n: (_rel(a.float(), e), e.abs().max().item())
           for n, a, e in zip(("O", *names), (o, *got), (o_want, *want))}
    log(phase, f"{tag}: K1 O max_abs_err {err_o:.3e} (budget {O_TOL_NAME}), LSE live rows "
                  f"max_abs_err {(lse[live] - lse_want[live]).abs().max().item():.3e} (budget "
                  f"{LSE_ATOL}); {'K5 + K6' if split else 'K3'} dQ/dK/dV "
                  f"max_abs_err {err_g:.3e} (budget BWD_TOL[bf16] atol {g_tol.atol} rtol "
                  f"{g_tol.rtol}); relative L2 (limit {WINDOW_REL_L2}) / max|ref|: "
                  + ", ".join(f"{n} {r:.2e} / {m:.3f}" for n, (r, m) in rel.items())
                  + f"; dead rows {int(dead.sum())}, their O and dQ exactly 0: {dead_zero}")
    if not (ok_o and ok_l):
        fail(f"K1 disagrees with fwd_reference at {tag}: {msg_o}; {msg_l}")
    if not ok_g:
        fail(f"the backward disagrees with its plain version at {tag}: {why_g}")
    if not all(r <= WINDOW_REL_L2 for r, _ in rel.values()):
        fail(f"relative L2 error above {WINDOW_REL_L2} at {tag}: {rel}")
    if not dead_zero:
        fail(f"dead rows at {tag}: O or dQ not exactly 0")
    dbias = got[1] if want_dbias else None
    del o, got, want, f32
    torch.cuda.empty_cache()
    return {"fwd_err": err_o, "bwd_err": err_g, "args": args, "dead": int(dead.sum()),
            "dbias": dbias}


def phase_window_check() -> dict:
    """The sliding-window and soft-capped variants against their plain
    versions (_fwd_bwd_check), all on q, k scaled by GROW: K1 and K3 with
    each window of WINDOW_CASES; K1 and K5 + K6 with a window and segment
    ids, without and with softcap 50; K1 and K5 + K6 with softcap 50 and the
    SWA window at bench_lm's long shape; K1 with softcap and the cache-slot
    bias at bench_decode's shape, GQA-folded. Times each at the path's shape
    beside its plain version and its library call, the kernels with a window
    beside the same kernel full-causal (gated: at most 0.6x), and prints the
    tile pairs each visits."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.ops.flash import flash_attention
    from flashattn_tpu_torch.utils.testing import FWD_TOL, check_close, make_qkv

    res = {}
    for i, (name, B, Hq, Hkv, Nq, Nk, D, causal, window) in enumerate(WINDOW_CASES):
        q, k, v = _grown(1000 + i, B, Hq, Nq, D, Nk, Hkv)
        do = _bnhd(make_qkv(1100 + i, B, Hq, Nq, D, dtype=torch.bfloat16, device=DEVICE)[0])
        kw = dict(scale=D ** -0.5, causal=causal, window=window)
        out = _fwd_bwd_check(f"{name} B{B} Hq{Hq} Hkv{Hkv} Nq{Nq} Nk{Nk} D{D} "
                             f"{'causal' if causal else 'non-causal'} window {window}",
                             q, k, v, do, **kw)
        if name == "dead-rows" and not out["dead"]:
            fail("the dead-row window case has no dead row")
        if name == "swa":
            swa = out["args"], kw, out["fwd_err"], out["bwd_err"]
        del q, k, v, do, out
    # Packed documents with a window, without and with softcap: K1's windowed
    # segment variants and K5 + K6's windowed ones, at bench_lm's packed shape.
    B, Hq, Hkv, N, _, D = SEG_CASES[0][1:7]
    ids = packed_ids(B, N + 1)[:, :N]
    for cap in (None, SOFTCAP):
        q, k, v = _grown(1050, B, Hq, N, D, N, Hkv)
        do = _bnhd(make_qkv(1051, B, Hq, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
        kw = dict(scale=D ** -0.5, causal=True, window=(GATE_WINDOW - 1, -1),
                  segment_ids=(ids, ids), **({} if cap is None else {"softcap": cap}))
        _fwd_bwd_check(f"packed B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal, 8 documents per row, "
                       f"window {kw['window']}{'' if cap is None else f', softcap {cap}'}",
                       q, k, v, do, **kw)
        del q, k, v, do

    (q, k, v, do, lse, delta), kw, k1_err, k3_err = swa
    B, Hq, Hkv, N, _, D = WINDOW_CASES[0][1:7]
    wl = kw["window"][0]
    mask = dict(kv_valid_len=N, causal=True, segment_ids=None, window=kw["window"])
    band = flash_fwd.pair_mask(N, N, device=DEVICE, **mask)[0, 0]
    stats, grad = 4 * B * Hq * N, 4 * B * Hq * N * D
    full = dict(scale=kw["scale"], causal=True)
    k1 = {"max_abs_err": k1_err, "ms": cuda_ms(lambda: flash_fwd.fwd(q, k, v, **kw)),
          "plain_ms": cuda_ms(lambda: flash_fwd.fwd_reference(q, k, v, **kw), reps=3, trials=3),
          **bound(tensor_bytes(q, k, v, q) + stats, pair_flops(q, k, matmuls=2, **mask)),
          "library_ms": sdpa_ms(q, k, v, attn_mask=band),
          "library_call": "scaled_dot_product_attention(attn_mask=band, enable_gqa=True)"}
    k1_full = cuda_ms(lambda: flash_fwd.fwd(q, k, v, **full))
    args = (q, k, v, do, lse, delta)
    k3 = {"max_abs_err": k3_err, "ms": cuda_ms(lambda: flash_bwd_fused.bwd(*args, **kw)),
          "plain_ms": cuda_ms(lambda: flash_bwd_fused.bwd_reference(*args, **kw), reps=2,
                              trials=3),
          **bound(tensor_bytes(*args) + 3 * grad, pair_flops(q, k, matmuls=5, **mask)),
          "library_ms": sdpa_ms(q, k, v, do=do, attn_mask=band),
          "library_call": "the backward of scaled_dot_product_attention(attn_mask=band)"}
    k3_full = cuda_ms(lambda: flash_bwd_fused.bwd(*args, **full))
    bm = 64 if D <= 64 else 32  # K3's Q tile (csrc/dkv_tile.cuh block_m)
    tiles = {"K1": (band_tiles(N, N, 64, 64, wl, 0), band_tiles(N, N, 64, 64, None, 0)),
             "K3": (band_tiles(N, N, 64, bm, 0, wl), band_tiles(N, N, 64, bm, 0, None))}
    for name, res_k, full_ms in (("K1", k1, k1_full), ("K3", k3, k3_full)):
        visited, causal_pairs = tiles[name]
        log("window", f"{name} window {kw['window']} causal at B{B} Hq{Hq} Hkv{Hkv} N{N} D{D}: "
                      f"{res_k['ms']:.4f} ms vs {name} full causal {full_ms:.4f} ms "
                      f"({res_k['ms'] / full_ms:.3f}x, gate 0.6x); tile pairs per head "
                      f"{visited} vs full causal {causal_pairs} ({visited / causal_pairs:.3f}); "
                      f"plain {res_k['plain_ms']:.4f} ms, bound {res_k['bound_ms']:.4f} ms "
                      f"({res_k['bound_by']}), SDPA with the band mask {res_k['library_ms']:.4f} ms")
        if not res_k["ms"] <= 0.6 * full_ms:
            fail(f"{name} with window {kw['window']} takes {res_k['ms']:.4f} ms, more than 0.6x "
                 f"{name} full causal ({full_ms:.4f} ms)")
    res["k1_window"], res["k3_window"] = k1, k3
    del q, k, v, do, lse, delta, args, band, swa
    torch.cuda.empty_cache()

    # Soft-capped training attention: the SWA shape with Gemma-2's cap.
    q, k, v = _grown(1200, B, Hq, N, D, N, Hkv)
    do = _bnhd(make_qkv(1201, B, Hq, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    kw = dict(kw, softcap=SOFTCAP)
    out = _fwd_bwd_check(f"softcap {SOFTCAP} window {kw['window']} causal B{B} Hq{Hq} Hkv{Hkv} "
                         f"N{N} D{D}", q, k, v, do, **kw)
    args = out["args"]
    flex_kw = dict(scale=kw["scale"], score_mod=softcap_mod(SOFTCAP), mask_mod=band_mod(wl))
    fwd_library = dict(library_ms=flex_ms(q, k, v, **flex_kw), library_call=(
        "flex_attention (torch.compile) with the softcap score_mod and the band block mask"))
    bwd_library = dict(library_ms=flex_ms(q, k, v, do=do, **flex_kw), library_call=(
        "the backward of flex_attention (torch.compile) with the softcap score_mod and the "
        "band block mask (dQ, dK and dV in one call)"))
    res["k1_softcap"] = {"max_abs_err": out["fwd_err"],
                         "ms": cuda_ms(lambda: flash_fwd.fwd(q, k, v, **kw)),
                         "plain_ms": cuda_ms(lambda: flash_fwd.fwd_reference(q, k, v, **kw),
                                             reps=3, trials=3),
                         **bound(tensor_bytes(q, k, v, q) + stats,
                                 pair_flops(q, k, matmuls=2, **mask)), **fwd_library}
    res["k5_softcap"] = {"max_abs_err": out["bwd_err"],
                         "ms": cuda_ms(lambda: flash_bwd.dkv(*args, **kw)),
                         "plain_ms": cuda_ms(lambda: flash_bwd.dkv_reference(*args, **kw),
                                             reps=2, trials=3),
                         **bound(tensor_bytes(*args) + 2 * grad,
                                 pair_flops(q, k, matmuls=4, **mask)), **bwd_library}
    res["k6_softcap"] = {"max_abs_err": out["bwd_err"],
                         "ms": cuda_ms(lambda: flash_bwd.dq(*args, **kw)),
                         "plain_ms": cuda_ms(lambda: flash_bwd.dq_reference(*args, **kw),
                                             reps=2, trials=3),
                         **bound(tensor_bytes(*args) + grad,
                                 pair_flops(q, k, matmuls=3, **mask)), **bwd_library}
    log("window", f"softcap at the SWA shape: K1 {res['k1_softcap']['ms']:.4f} ms (plain "
                  f"{res['k1_softcap']['plain_ms']:.4f}, flex_attention "
                  f"{fwd_library['library_ms']:.4f}), K5 {res['k5_softcap']['ms']:.4f} ms "
                  f"(plain {res['k5_softcap']['plain_ms']:.4f}), K6 {res['k6_softcap']['ms']:.4f} "
                  f"ms (plain {res['k6_softcap']['plain_ms']:.4f}), flex_attention's backward "
                  f"{bwd_library['library_ms']:.4f} ms; K1 window without the cap "
                  f"{k1['ms']:.4f} ms, K3 window {k3['ms']:.4f} ms (median CUDA-event time)")
    del q, k, v, do, args, out
    torch.cuda.empty_cache()

    # Soft-capped decode: K1 with the cap and the cache-slot bias, folded.
    b, hq, hkv, nk, d = DECODE_B, DECODE_H, 8, DECODE_NK, DECODE_D
    q, k, v = make_qkv(1300, b, hq, 1, d, Nk=nk, Hkv=hkv, device=DEVICE)
    q, k, v = (x.to(torch.bfloat16) for x in (GROW * q, GROW * k, v))
    bias = _decode_slot_bias(nk, nk // 2)
    o = flash_attention(q, k, v, bias=bias, logit_softcap=SOFTCAP)
    torch.cuda.synchronize()
    kw = dict(scale=d ** -0.5, bias=bias, softcap=SOFTCAP)
    o_want, _ = flash_fwd.fwd_reference(q.float(), k.float(), v.float(), **kw)
    ok, msg = check_close(o, o_want, FWD_TOL[torch.bfloat16], "O")
    err = (o.float() - o_want).abs().max().item()
    qf = q.reshape(b, hkv, hq // hkv, d)  # the folded launch the path makes
    res["k1_softcap_bias"] = {
        "max_abs_err": err, "ms": cuda_ms(lambda: flash_fwd.fwd(qf, k, v, **kw)),
        "plain_ms": cuda_ms(lambda: flash_fwd.fwd_reference(q, k, v, **kw), reps=3, trials=3),
        **bound(tensor_bytes(q, k, v, bias, q) + 4 * b * hq, 4.0 * d * b * hq * nk),
        "library_ms": flex_ms(q, k, v, scale=kw["scale"], score_mod=softcap_mod(SOFTCAP, bias)),
        "library_call": "flex_attention (torch.compile) with the softcap and bias score_mod"}
    log("window", f"softcap {SOFTCAP} + cache-slot bias B{b} Hq{hq} Hkv{hkv} Nq1 Nk{nk} D{d} "
                  f"folded (q, k x{GROW}): O max_abs_err {err:.3e} (budget {O_TOL_NAME}, "
                  f"max|ref| {o_want.abs().max().item():.3f}); K1 "
                  f"{res['k1_softcap_bias']['ms'] * 1e3:.2f} us, plain "
                  f"{res['k1_softcap_bias']['plain_ms'] * 1e3:.2f} us, flex_attention "
                  f"{res['k1_softcap_bias']['library_ms'] * 1e3:.2f} us")
    if not ok:
        fail(f"K1 softcap + bias disagrees with fwd_reference at the decode shape: {msg}")
    return res


def phase_swa_train() -> dict:
    """Sliding-window training (bench_lm.py:141-151): loss and gradient gates
    at [1, 2049] tokens with sliding_window 512, fused vs xla (gradients
    within 1.5x this run's bf16 floor); LM_STEPS fused AdamW steps at
    [1, 8193] with sliding_window 2048 (exactly K1 = K1 window = K3 =
    layers x steps, no K5/K6) beside LM_STEPS full-causal steps; then
    SWA_REMAT_STEPS steps at [1, 16385] with remat (the recomputed forward
    launches K1 twice per layer). Returns the windowed steps' launch counts."""
    from flashattn_tpu_torch.models.transformer import TransformerConfig

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    tokens = torch.randint(0, LM_WIDTH["vocab_size"], (1, LM_SEQ + 1), generator=gen,
                           device=DEVICE)
    _lm_gates(TransformerConfig(**LM_WIDTH, sliding_window=GATE_WINDOW), tokens, None, None,
              "swa")
    cfg = TransformerConfig(**LM_WIDTH, sliding_window=SWA_WINDOW)
    tokens = torch.randint(0, cfg.vocab_size, (1, SWA_SEQ + 1), generator=gen, device=DEVICE)
    _reset_launches()
    swa_s = _lm_steps(cfg, tokens, "fused", phase="swa",
                      label=f"fused, sliding_window {SWA_WINDOW}")
    counts = _launches()
    full_s = _lm_steps(TransformerConfig(**LM_WIDTH), tokens, "fused", phase="swa",
                       label="fused, full causal")
    n = cfg.n_layers * LM_STEPS
    log("swa", f"windowed step / full-causal step at [1, {SWA_SEQ + 1}]: {swa_s / full_s:.3f}")
    log("swa", f"launches during the windowed steps: {counts} (expected K1 = K1 window = K3 = "
               f"{cfg.n_layers} layers x {LM_STEPS} steps = {n}, no other)")
    if counts != _expect(K1=n, K1_window=n, K3=n):
        fail(f"SWA steps launched {counts}, expected K1 = K1 window = K3 = {n} and no other")

    cfg = dataclasses.replace(cfg, remat=True)
    tokens = torch.randint(0, cfg.vocab_size, (1, SWA_REMAT_SEQ + 1), generator=gen,
                           device=DEVICE)
    _reset_launches()
    _lm_steps(cfg, tokens, "fused", phase="swa", label=f"fused, sliding_window {SWA_WINDOW}, remat",
              steps=SWA_REMAT_STEPS, warmup=1)
    remat = _launches()
    n = cfg.n_layers * SWA_REMAT_STEPS
    log("swa", f"launches during the remat steps: {remat} (expected K1 = K1 window = 2 x {n} "
               f"(forward and its recomputation), K3 = {n})")
    if remat != _expect(K1=2 * n, K1_window=2 * n, K3=n):
        fail(f"SWA remat steps launched {remat}, expected K1 = K1 window = {2 * n}, K3 = {n}")
    return counts


def phase_softcap() -> dict:
    """Soft-capped training and decode. Training: the LM with logit_softcap
    50 and sliding_window 512, gates at [1, 2049] as phase_swa_train's; then
    LM_STEPS fused steps at [1, 8193] with the cap and sliding_window 2048:
    exactly K1 = K1 window = K1 softcap = K5 = K6 = layers x steps, no K3.
    Decode: bench_decode's LM with the cap and sliding_window 2048 on a bf16
    cache, decode against the teacher-forced forward (_decode_gate; the
    forward runs K1 with the window and the cap), ms/token at cache lengths
    1024-8192 with exactly 16 K1 softcap launches per step, all with the
    cache-slot bias. Returns both paths' launch counts."""
    from flashattn_tpu_torch.models.transformer import TransformerConfig, init_transformer

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    tokens = torch.randint(0, LM_WIDTH["vocab_size"], (1, LM_SEQ + 1), generator=gen,
                           device=DEVICE)
    _lm_gates(TransformerConfig(**LM_WIDTH, sliding_window=GATE_WINDOW, logit_softcap=SOFTCAP),
              tokens, None, None, "softcap")
    cfg = TransformerConfig(**LM_WIDTH, sliding_window=SWA_WINDOW, logit_softcap=SOFTCAP)
    tokens = torch.randint(0, cfg.vocab_size, (1, SWA_SEQ + 1), generator=gen, device=DEVICE)
    _reset_launches()
    _lm_steps(cfg, tokens, "fused", phase="softcap",
              label=f"fused, logit_softcap {SOFTCAP}, sliding_window {SWA_WINDOW}")
    train = _launches()
    n = cfg.n_layers * LM_STEPS
    log("softcap", f"launches during the soft-capped steps: {train} (expected K1 = K1 window = "
                   f"K1 softcap = K5 = K6 = {n}, no K3)")
    if train != _expect(K1=n, K1_window=n, K1_softcap=n, K5=n, K6=n):
        fail(f"soft-capped steps launched {train}, expected K1 = K1 window = K1 softcap = K5 = "
             f"K6 = {n} and no other")

    cfg = TransformerConfig(**DECODE_WIDTH, sliding_window=SWA_WINDOW, logit_softcap=SOFTCAP)
    model = init_transformer(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, (2, DECODE_GATE_TOKENS), generator=gen,
                           device=DEVICE)
    _decode_gate(model, cfg, tokens, "softcap")
    _reset_launches()
    for cache_len in DECODE_CACHE_LENS:
        _decode_ms(model, cfg, cache_len, None, phase="softcap",
                   label=f"bf16 cache, logit_softcap {SOFTCAP}, sliding_window {SWA_WINDOW}")
    decode = _launches()
    n = cfg.n_layers * (DECODE_WARMUP + DECODE_STEPS) * len(DECODE_CACHE_LENS)
    log("softcap", f"launches during the soft-capped decode steps: {decode} (expected "
                   f"{cfg.n_layers} per step, K1 = K1 bias = K1 softcap = {n})")
    if decode != _expect(K1=n, K1_bias=n, K1_softcap=n):
        fail(f"soft-capped decode launched {decode}, expected K1 = K1 bias = K1 softcap = {n}")
    del model
    torch.cuda.empty_cache()
    return {"train": train, "decode": decode}


# Bias-gradient training (path A): the counterpart of flax's
# MultiHeadDotProductAttention at the LM's attention width (16 heads of 128,
# integrations/torch_nn.py), over a key-padding mask of these row lengths built
# as nn.make_attention_mask builds it; the padded rows are left out of the
# loss. phase_bias_check also holds the kernels at the LM's attention shape
# (B, Hq, Hkv, N, D), causal, with a learned [1, Hq, N, N] bias.
ATTN_WIDTH = dict(num_heads=16, in_features=2048, qkv_features=2048)
ATTN_LENGTHS = (2048, 1536, 1024, 512)
ATTN_SEQ = 2048
BIAS_SHAPE = (2, 16, 8, 2048, 128)
# phase_roofline: K9 at 4096^3 and at the JAX test's 512 x 256 x 384; K10
# checked at size 256 with 4 iterations and timed at the JAX probe's default
# (size 512, 1024 iterations); the chained torch.matmul at size 4096.
GEMM_SHAPES = ((4096, 4096, 4096), (512, 256, 384))
ROOFLINE_SIZE, ROOFLINE_ITERS = 512, 1024
MATMUL_PEAK_SIZE = 4096


def _padding_bias(lengths, n: int) -> torch.Tensor:
    """The f32 bias ``[B, 1, n, n]`` of a key-padding mask of row
    ``lengths`` (``make_attention_mask`` of the valid flags, then the
    adapter's 0 / DEFAULT_MASK_VALUE): rows past a length are dead."""
    from flashattn_tpu_torch.integrations import make_attention_mask
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE

    valid = torch.arange(n, device=DEVICE)[None] < torch.tensor(lengths, device=DEVICE)[:, None]
    mask = make_attention_mask(valid, valid, dtype=torch.bool)
    return torch.where(mask, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)


def _bias_e2e(tag: str, q, k, v, bias, do, **fkw):
    """Gradients of ``flash_attention(bias=)`` (dQ, dK, dV, dbias) against
    autograd through the f32 oracle on f32 copies: BWD_TOL[bf16] and each
    within WINDOW_REL_L2 relative L2; dbias of the bias's shape and dtype.
    Returns dbias."""
    from flashattn_tpu_torch.ops.flash import flash_attention
    from flashattn_tpu_torch.ops.oracle import attention_reference
    from flashattn_tpu_torch.utils.testing import BWD_TOL, grad_gate

    leaves = [x.detach().requires_grad_(True) for x in (q, k, v, bias)]
    got = torch.autograd.grad(flash_attention(*leaves[:3], bias=leaves[3], **fkw), leaves, do)
    torch.cuda.synchronize()
    ref = [x.detach().float().requires_grad_(True) for x in (q, k, v, bias)]
    o_ref = attention_reference(*ref[:3], bias=ref[3], causal=fkw.get("causal", False),
                                logit_softcap=fkw.get("logit_softcap"))
    want = torch.autograd.grad(o_ref, ref, do.float())
    names = ("dq", "dk", "dv", "dbias")
    g_tol = BWD_TOL[torch.bfloat16]
    ok, why, err, _ = grad_gate(got, want, g_tol, names=names)
    rel = {n: (_rel(a.float(), e), e.abs().max().item()) for n, a, e in zip(names, got, want)}
    log("bias", f"flash_attention(bias=) end to end, {tag}: dQ/dK/dV/dbias max_abs_err "
                f"{err:.3e} (budget BWD_TOL[bf16] atol {g_tol.atol} rtol {g_tol.rtol}) against "
                f"autograd through the f32 oracle; relative L2 (limit {WINDOW_REL_L2}) / "
                f"max|ref|: " + ", ".join(f"{n} {r:.2e} / {m:.3f}" for n, (r, m) in rel.items())
                + f"; dbias {list(got[3].shape)} {got[3].dtype}")
    if not ok:
        fail(f"flash_attention(bias=) gradients disagree with the oracle's ({tag}): {why}")
    if not all(r <= WINDOW_REL_L2 for r, _ in rel.values()):
        fail(f"relative L2 error above {WINDOW_REL_L2} ({tag}): {rel}")
    if got[3].shape != bias.shape or got[3].dtype != bias.dtype:
        fail(f"dbias {tuple(got[3].shape)} {got[3].dtype} is not the bias's "
             f"{tuple(bias.shape)} {bias.dtype} ({tag})")
    return got[3]


def phase_bias_check() -> dict:
    """K1, K5 and K6 with a bias, and K6's dbias, against their plain
    versions (_fwd_bwd_check, q and k scaled by GROW): at path A's attention
    (B4 H16 N2048 D128 non-causal) with its mask arm's bias (the key-padding
    bias [4, 1, N, N] of ATTN_LENGTHS, with dead rows; no dbias, as a mask
    wants none) and its learned arm's (that bias plus a learned [1, 16, N, N]
    one, [4, 16, N, N], with dbias); at the LM's attention shape B2 Hq16 Hkv8
    N2048 D128 causal with a learned [1, 16, N, N] bias, without and with
    softcap 50 (dbias, exactly 0 above the diagonal). Then
    flash_attention(bias=) end to end against autograd through the f32 oracle
    (_bias_e2e): the learned bias, a trainable [2, 1, 1, N] padding bias,
    softcap + the learned bias, and the GQA decode fold with a [B, 1, Nq, Nk]
    bias, whose repeated rows sum back (4 K6 dbias launches). Times K1, K5
    and K6 with the mask arm's bias and K6 with dbias with the learned arm's,
    beside their plain versions and SDPA, and K6 with and without dbias at
    the causal shape beside its bound."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
    from flashattn_tpu_torch.utils.testing import make_qkv

    res = {}
    B, N = len(ATTN_LENGTHS), ATTN_SEQ
    H = ATTN_WIDTH["num_heads"]
    D = ATTN_WIDTH["qkv_features"] // H
    q, k, v = _grown(1400, B, H, N, D, N, H)
    do = _bnhd(make_qkv(1401, B, H, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    pad = _padding_bias(ATTN_LENGTHS, N)
    kw = dict(scale=D ** -0.5, bias=pad)
    out = _fwd_bwd_check(f"path A's attention B{B} H{H} N{N} D{D} non-causal, key-padding bias "
                         f"[{B}, 1, {N}, {N}] of lengths {ATTN_LENGTHS}", q, k, v, do,
                         phase="bias", **kw)
    if not out["dead"]:
        fail("the key-padding case has no dead row")
    args = out["args"]
    stats, grad = 4 * B * H * N, 4 * B * H * N * D
    mask = dict(kv_valid_len=N, causal=False, segment_ids=None)
    bwd_library = dict(library_ms=sdpa_ms(q, k, v, do=do, attn_mask=pad), library_call=(
        "the backward of scaled_dot_product_attention(attn_mask=the key-padding bias) (dQ, dK "
        "and dV in one call)"))
    res["k1_bias"] = {
        "max_abs_err": out["fwd_err"], "ms": cuda_ms(lambda: flash_fwd.fwd(q, k, v, **kw)),
        "plain_ms": cuda_ms(lambda: flash_fwd.fwd_reference(q, k, v, **kw), reps=3, trials=3),
        **bound(tensor_bytes(q, k, v, pad, q) + stats, pair_flops(q, k, matmuls=2, **mask)),
        "library_ms": sdpa_ms(q, k, v, attn_mask=pad),
        "library_call": "scaled_dot_product_attention(attn_mask=the key-padding bias)"}
    res["k5_bias"] = {
        "max_abs_err": out["bwd_err"], "ms": cuda_ms(lambda: flash_bwd.dkv(*args, **kw)),
        "plain_ms": cuda_ms(lambda: flash_bwd.dkv_reference(*args, **kw), reps=2, trials=3),
        **bound(tensor_bytes(*args, pad) + 2 * grad, pair_flops(q, k, matmuls=4, **mask)),
        **bwd_library}
    res["k6_bias"] = {
        "max_abs_err": out["bwd_err"], "ms": cuda_ms(lambda: flash_bwd.dq(*args, **kw)),
        "plain_ms": cuda_ms(lambda: flash_bwd.dq_reference(*args, **kw), reps=2, trials=3),
        **bound(tensor_bytes(*args, pad) + grad, pair_flops(q, k, matmuls=3, **mask)),
        **bwd_library}
    log("bias", f"path A's attention: K1 bias {res['k1_bias']['ms']:.4f} ms (plain "
                f"{res['k1_bias']['plain_ms']:.4f}, SDPA {res['k1_bias']['library_ms']:.4f}), "
                f"K5 bias {res['k5_bias']['ms']:.4f} ms (plain {res['k5_bias']['plain_ms']:.4f}), "
                f"K6 bias {res['k6_bias']['ms']:.4f} ms (plain {res['k6_bias']['plain_ms']:.4f}), "
                f"SDPA's backward {bwd_library['library_ms']:.4f} ms (median CUDA-event time)")
    del q, k, v, do, args, out
    torch.cuda.empty_cache()

    # Path A's learned arm: flash_attention_fn adds the key-padding bias and
    # the learned relative-position bias [1, H, N, N] into one [B, H, N, N] f32
    # bias that requires grad, so K6 writes dbias over every pair.
    gen = torch.Generator(device=DEVICE).manual_seed(1409)
    combined = pad + torch.randn((1, H, N, N), generator=gen, device=DEVICE)
    del pad
    q, k, v = _grown(1410, B, H, N, D, N, H)
    do = _bnhd(make_qkv(1411, B, H, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    kw = dict(scale=D ** -0.5, bias=combined)
    out = _fwd_bwd_check(f"path A's learned arm B{B} H{H} N{N} D{D} non-causal, bias [{B}, {H}, "
                         f"{N}, {N}] (key padding + learned [1, {H}, {N}, {N}]), dbias", q, k, v, do,
                         phase="bias", want_dbias=True, **kw)
    # SDPA takes a bias that requires grad only in the query's dtype.
    args, leaf = out["args"], combined.to(torch.bfloat16).requires_grad_(True)
    res["k6_dbias"] = {
        "max_abs_err": out["bwd_err"],
        "ms": cuda_ms(lambda: flash_bwd.dq(*args, want_dbias=True, **kw)),
        "plain_ms": cuda_ms(lambda: flash_bwd.dq_reference(*args, want_dbias=True, **kw), reps=2,
                            trials=3),
        **bound(tensor_bytes(*args, combined, out["dbias"]) + grad,
                pair_flops(q, k, matmuls=3, **mask)),
        "library_ms": sdpa_ms(q, k, v, do=do, attn_mask=leaf, bias_leaf=leaf),
        "library_call": ("the backward of scaled_dot_product_attention(attn_mask=the [B, H, N, N] "
                         "bias in bf16, which requires grad) (dQ, dK, dV and dbias in one call)")}
    no_dbias = cuda_ms(lambda: flash_bwd.dq(*args, **kw))
    log("bias", f"path A's learned arm: K6 with dbias {res['k6_dbias']['ms']:.4f} ms (plain "
                f"{res['k6_dbias']['plain_ms']:.4f}), without dbias {no_dbias:.4f} ms; bound "
                f"{res['k6_dbias']['bound_ms']:.4f} ms ({res['k6_dbias']['bound_by']}); SDPA's "
                f"backward with dbias {res['k6_dbias']['library_ms']:.4f} ms")
    del q, k, v, do, args, out, combined, leaf
    torch.cuda.empty_cache()

    B, Hq, Hkv, N, D = BIAS_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(1402)
    learned = torch.randn((1, Hq, N, N), generator=gen, device=DEVICE)
    upper = torch.ones((N, N), dtype=torch.bool, device=DEVICE).triu(1)
    for cap in (None, SOFTCAP):
        q, k, v = _grown(1403, B, Hq, N, D, N, Hkv)
        do = _bnhd(make_qkv(1404, B, Hq, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
        kw = dict(scale=D ** -0.5, causal=True, bias=learned,
                  **({} if cap is None else {"softcap": cap}))
        out = _fwd_bwd_check(f"learned bias [1, {Hq}, {N}, {N}] B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} "
                             f"causal{'' if cap is None else f', softcap {cap}'}, dbias",
                             q, k, v, do, phase="bias", want_dbias=True, **kw)
        above = int((out["dbias"][..., upper] != 0).sum())
        log("bias", f"dbias above the causal diagonal: {above} nonzero of "
                    f"{B * Hq * int(upper.sum())}")
        if above:
            fail(f"K6's dbias is not exactly 0 above the causal diagonal (cap {cap})")
        if cap is None:
            lm = out
        del q, k, v, do, out
        torch.cuda.empty_cache()

    args, kw = lm["args"], dict(scale=D ** -0.5, causal=True, bias=learned)
    # The batch-broadcast bias is read once over the attended pairs (on and
    # below the diagonal); dbias [B, Hq, N, N] is written whole.
    causal_bound = bound(tensor_bytes(*args, lm["dbias"]) + 4 * Hq * N * (N + 1) // 2
                         + 4 * B * Hq * N * D,
                         pair_flops(args[0], args[1], matmuls=3, kv_valid_len=N, causal=True,
                                    segment_ids=None))
    with_dbias = cuda_ms(lambda: flash_bwd.dq(*args, want_dbias=True, **kw))
    no_dbias = cuda_ms(lambda: flash_bwd.dq(*args, **kw))
    log("bias", f"learned bias B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal: K6 with dbias "
                f"{with_dbias:.4f} ms, without dbias {no_dbias:.4f} ms; bound "
                f"{causal_bound['bound_ms']:.4f} ms ({causal_bound['bound_by']})")
    del args, lm
    torch.cuda.empty_cache()

    # End to end at unit scale: these gradients also carry the bf16 rounding
    # of O and of Delta = rowsum(dO * O), which at GROW scale alone exceeds
    # BWD_TOL[bf16] elementwise (dQ off by 9.8e-2 at |ref| 6.4e-2 on the H100).
    _reset_launches()
    q, k, v = (_bnhd(x) for x in make_qkv(1405, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                           device=DEVICE))
    do = _bnhd(make_qkv(1406, B, Hq, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    dbias = _bias_e2e(f"learned bias [1, {Hq}, {N}, {N}], B{B} Hq{Hq} Hkv{Hkv} causal", q, k, v,
                      learned, do, causal=True)
    if (dbias[..., upper] != 0).any():
        fail("the reduced dbias is not exactly 0 above the causal diagonal")
    lengths = torch.tensor([N, 3 * N // 4], device=DEVICE)
    slots = torch.where(torch.arange(N, device=DEVICE)[None] < lengths[:, None], 0.0, -1e9)
    _bias_e2e(f"trainable padding bias [{B}, 1, 1, {N}], causal", q, k, v,
              slots[:, None, None], do, causal=True)
    _bias_e2e(f"softcap {SOFTCAP} + learned bias, causal", q, k, v, learned, do, causal=True,
              logit_softcap=SOFTCAP)
    nq = 2  # rep * Nq = 4 rows per KV head: folded
    qd = _bnhd(make_qkv(1407, B, Hq, nq, D, dtype=torch.bfloat16, device=DEVICE)[0])
    dod = _bnhd(make_qkv(1408, B, Hq, nq, D, dtype=torch.bfloat16, device=DEVICE)[0])
    rows = torch.randn((B, 1, nq, N), generator=gen, device=DEVICE)
    _bias_e2e(f"GQA decode fold Nq{nq}, bias [{B}, 1, {nq}, {N}] (rows repeated per q head)",
              qd, k, v, rows, dod)
    res["e2e"] = _launches()
    log("bias", f"launches during the end-to-end checks: {res['e2e']}")
    if res["e2e"]["K6 dbias"] != 4 or res["e2e"]["K3"]:
        fail(f"the end-to-end bias checks launched {res['e2e']}, expected K6 dbias = 4, no K3")
    return res


def _plain_mhdpa(m, x, bias):
    """The module's function written out apart from the port: the
    projections in the parameters' dtype, then softmax(q k^T · D^-1/2 + bias)
    v in f32 with the f32 ``bias`` [B|1, H, N, N], cast back. A gate's
    reference: it shares no code with flash_attention_fn, the SDPA adapter
    or the kernels."""
    q, k, v = ((torch.einsum("bnf,fhd->bhnd", x, p.kernel) + p.bias[:, None]).float()
               for p in (m.query, m.key, m.value))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5 + bias
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v).to(x.dtype)
    return torch.einsum("bhnd,hdf->bnf", o, m.out.kernel) + m.out.bias


def _path_a(arm: str, x, target, valid, mask, rel0) -> dict:
    """One arm of path A: FlashMultiHeadDotProductAttention (ATTN_WIDTH,
    bf16) on ``x`` with the key-padding ``mask`` and, where ``rel0`` is given,
    a trainable relative-position bias initialised to it (f32, passed as the
    module's ``bias``); an MSE loss over the valid rows. Loss and gradient
    gates: the bf16 floor is the plain bf16 function (_plain_mhdpa on the
    bf16 weights) against the plain f32 one on the unrounded weights; the
    fused and exact (impl "exact", the SDPA adapter's oracle) arms are each
    held to 1.5x that floor against the f32 one, over all gradients and,
    with a learned bias, over its gradient alone. Then LM_STEPS AdamW steps
    per arm (the learned bias trained with the weights), the launches of the
    fused steps counted."""
    from flashattn_tpu_torch.integrations import FlashMultiHeadDotProductAttention
    from flashattn_tpu_torch.models.transformer import adamw_init, adamw_update
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE

    B, N, F = x.shape

    def build(impl, dtype=torch.bfloat16):
        m = FlashMultiHeadDotProductAttention(
            **ATTN_WIDTH, impl=impl, dtype=dtype, device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(0))
        rel = None if rel0 is None else torch.nn.Parameter(rel0.clone())
        return m, rel

    def loss_of(m, rel, plain=False):
        dtype = m.out.kernel.dtype
        if plain:
            bias = torch.where(mask, 0.0, DEFAULT_MASK_VALUE)
            y = _plain_mhdpa(m, x.to(dtype), bias if rel is None else bias + rel)
        else:
            y = m(x.to(dtype), mask=mask, bias=rel)
        return ((y.float() - target) ** 2 * valid[..., None]).sum() / (valid.sum() * F)

    def params_of(m, rel):
        return {**dict(m.named_parameters()), **({} if rel is None else {"rel_bias": rel})}

    def loss_and_grads(m, rel, plain=False):
        params = params_of(m, rel)
        for p in params.values():
            p.grad = None
        loss = loss_of(m, rel, plain)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in params.items()}

    fused, exact = build("fused"), build("exact")
    n_params = sum(p.numel() for p in params_of(*fused).values())
    got = {"fused": loss_and_grads(*fused), "exact": loss_and_grads(*exact)}
    l16, g16 = loss_and_grads(*build("exact"), plain=True)
    l32, g32 = loss_and_grads(*build("exact", torch.float32), plain=True)
    for name, (loss, g) in (*got.items(), ("plain bf16", (l16, g16)), ("plain f32", (l32, g32))):
        if not math.isfinite(loss) or not all(torch.isfinite(t).all() for t in g.values()):
            fail(f"path A {arm}, {name}: loss {loss} or its gradients are not finite")
    only = {} if rel0 is None else {"rel_bias": "the learned bias's gradient"}
    floors = {"loss": abs(l16 - l32), "gradients": _rel_l2(g16, g32),
              **{n: _rel_l2({n: g16[n]}, {n: g32[n]}) for n in only}}
    errs = {name: {"loss": abs(loss - l32), "gradients": _rel_l2(g, g32),
                   **{n: _rel_l2({n: g[n]}, {n: g32[n]}) for n in only}}
            for name, (loss, g) in got.items()}
    what = f"key-padding mask of lengths {ATTN_LENGTHS}" + (
        "" if rel0 is None else f" + a trainable bias {list(rel0.shape)} f32")
    log("bias_train", f"{arm} arm: FlashMultiHeadDotProductAttention ({n_params / 1e6:.1f} M "
                      f"params, {ATTN_WIDTH['num_heads']} heads of "
                      f"{ATTN_WIDTH['qkv_features'] // ATTN_WIDTH['num_heads']}, bf16) on x "
                      f"[{B}, {N}, {F}], {what}: loss fused {got['fused'][0]:.7f}, exact "
                      f"{got['exact'][0]:.7f}, plain bf16 {l16:.7f}, plain f32 {l32:.7f}; "
                      + "; ".join(f"{key} against plain f32: fused {errs['fused'][key]:.3e}, exact "
                                  f"{errs['exact'][key]:.3e} (limit 1.5 x bf16 floor "
                                  f"{floors[key]:.3e}, plain bf16 vs plain f32)"
                                  for key in floors))
    for name, err in errs.items():
        for key, floor in floors.items():
            if not err[key] <= 1.5 * floor:
                fail(f"path A {arm} gate, {name} {only.get(key, key)}: {err[key]:.3e} against "
                     f"the plain f32 function > 1.5 x the bf16 floor {floor:.3e}")
    del got, g16, g32

    res = {}
    for name, (model, rel) in (("fused", fused), ("exact", exact)):
        params = params_of(model, rel)
        opt = adamw_init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if name == "fused":
            _reset_launches()
        losses, secs = [], []
        for _ in range(LM_STEPS):
            t0 = time.perf_counter()
            for p in params.values():
                p.grad = None
            loss = loss_of(model, rel)
            loss.backward()
            adamw_update({n: p.grad for n, p in params.items()}, opt, params)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(loss.item())
        if name == "fused":
            res["launches"] = _launches()
        step_s = statistics.median(secs[LM_WARMUP:])
        res[name] = {"ms_per_step": step_s * 1e3,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log("bias_train", f"{arm} arm, {name}: {LM_STEPS} AdamW steps, {step_s * 1e3:.2f} ms/step "
                          f"({', '.join(f'{s * 1e3:.1f}' for s in secs)}; median after "
                          f"{LM_WARMUP} warm-up steps), peak {res[name]['peak_gb']:.2f} GB; loss "
                          f"{losses[0]:.5f} -> {losses[-1]:.5f}")
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            fail(f"path A {arm} arm, {name} training: losses {losses} not finite or not falling")
        del params, opt
    n, dbias = LM_STEPS, (0 if rel0 is None else LM_STEPS)
    log("bias_train", f"{arm} arm, launches during the fused steps: {res['launches']} (expected "
                      f"K1 = K1 bias = K5 = K5 bias = K6 = K6 bias = {n}, K6 dbias = {dbias}, no "
                      f"K3)")
    if res["launches"] != _expect(K1=n, K1_bias=n, K5=n, K5_bias=n, K6=n, K6_bias=n,
                                  K6_dbias=dbias):
        fail(f"path A's {arm} arm launched {res['launches']}, expected K1 = K1 bias = K5 = K5 "
             f"bias = K6 = K6 bias = {n}, K6 dbias = {dbias} and no other")
    del fused, exact
    torch.cuda.empty_cache()
    return res


def phase_bias_train() -> dict:
    """Path A: FlashMultiHeadDotProductAttention (16 heads, qkv_features
    2048, bf16, impl "fused") on x [4, 2048, 2048] with the key-padding mask of
    ATTN_LENGTHS ([B, 1, N, N] boolean, as nn.make_attention_mask builds it),
    an MSE loss over the valid rows against a random target at the output's
    scale, in two arms (_path_a): the mask alone, which needs no dbias, and
    the mask plus a trainable relative-position bias [1, 16, N, N] (a T5 /
    Swin-style learned bias), whose gradient K6's dbias gives."""
    from flashattn_tpu_torch.integrations import make_attention_mask

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    B, N, F = len(ATTN_LENGTHS), ATTN_SEQ, ATTN_WIDTH["in_features"]
    x = torch.randn((B, N, F), generator=gen, device=DEVICE)
    # The target at the output's own scale (its std is ~0.044 at this width),
    # so that the loss moves with the attention's output and not only with
    # the target's variance.
    target = 0.05 * torch.randn((B, N, F), generator=gen, device=DEVICE)
    valid = torch.arange(N, device=DEVICE)[None] < torch.tensor(ATTN_LENGTHS, device=DEVICE)[:, None]
    mask = make_attention_mask(valid, valid, dtype=torch.bool)
    res = {"mask": _path_a("mask", x, target, valid, mask, None)}
    rel0 = torch.randn((1, ATTN_WIDTH["num_heads"], N, N), generator=gen, device=DEVICE)
    res["learned"] = _path_a("learned", x, target, valid, mask, rel0)
    return res


def phase_roofline() -> dict:
    """Path B, the roofline probes: gemm.matmul (K9) at 4096^3 and at the
    JAX test's 512 x 256 x 384 (blocks 128), and measure_mxu_peak_tflops
    (K10, size 512, 1024 iterations) -- the launches counted -- then K9's
    outputs against its plain version (bf16 out: FWD_TOL[bf16]; f32 out at
    the small shape: FWD_TOL[f32]) and K10 against its plain version at size
    256, 4 iterations (FWD_TOL[bf16]); the HMMA instructions of K10's SASS
    (at least 2 x N_CHAINS: its chains' products are neither merged nor
    hoisted) and the measured mma.sync peak at most the datasheet's 989
    TFLOP/s; the chained torch.matmul peak beside it. Times K9 and K10 beside
    their plain versions and torch.matmul."""
    from flashattn_tpu_torch.ops import gemm, roofline
    from flashattn_tpu_torch.utils import native
    from flashattn_tpu_torch.utils.testing import FWD_TOL, check_close

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    operands = [tuple(torch.randn(s, generator=gen, device=DEVICE).to(torch.bfloat16)
                      for s in ((m, kd), (kd, n))) for m, n, kd in GEMM_SHAPES]
    _reset_launches()
    outs = [gemm.matmul(*operands[0]), gemm.matmul(*operands[1], block_m=128, block_n=128,
                                                   block_k=128)]
    mxu = roofline.measure_mxu_peak_tflops(size=ROOFLINE_SIZE, iters=ROOFLINE_ITERS)
    counts = _launches()
    log("roofline", f"launches driving the probes: {counts} (expected K9 = 2, K10 > 0, no other)")
    if counts != _expect(K9=2, K10=counts["K10"]) or not counts["K10"]:
        fail(f"the roofline probes launched {counts}, expected K9 = 2, K10 > 0 and no other")

    res = {"launches": counts, "mxu_tflops": mxu}
    for (m, n, kd), (a, b), out in zip(GEMM_SHAPES, operands, outs):
        want = gemm.matmul_reference(a, b, torch.float32)
        ok, msg = check_close(out, want, FWD_TOL[torch.bfloat16], "K9 bf16")
        err = (out.float() - want).abs().max().item()
        msg32 = ""
        if (m, n, kd) != GEMM_SHAPES[0]:
            out32 = gemm.matmul(a, b, block_m=128, block_n=128, block_k=128,
                                out_dtype=torch.float32)
            ok32, msg32 = check_close(out32, want, FWD_TOL[torch.float32], "K9 f32")
            ok = ok and ok32
            msg32 = f"; f32 out max_abs_err {(out32 - want).abs().max().item():.3e} (FWD_TOL[f32])"
        log("roofline", f"K9 {m}x{kd} @ {kd}x{n} bf16: bf16 out max_abs_err {err:.3e} "
                        f"(FWD_TOL[bf16], max|ref| {want.abs().max().item():.2f}){msg32}")
        if not ok:
            fail(f"K9 disagrees with its plain version at {m}x{kd}x{n}: {msg} {msg32}")
        if (m, n, kd) == GEMM_SHAPES[0]:
            k9_err = err
    a, b = (torch.randn((256, 256), generator=gen, device=DEVICE).to(torch.bfloat16)
            for _ in range(2))
    out = roofline.roofline_call(a, b, iters=4, size=256)
    want = roofline.roofline_reference(a.float(), b.float(), iters=4)
    ok, msg = check_close(out, want, FWD_TOL[torch.bfloat16], "K10")
    k10_err = (out.float() - want).abs().max().item()
    log("roofline", f"K10 size 256, 4 iterations: max_abs_err {k10_err:.3e} (FWD_TOL[bf16], "
                    f"max|ref| {want.abs().max().item():.2f})")
    if not ok:
        fail(f"K10 disagrees with its plain version: {msg}")

    names = {"K10 roofline_kernel<4>", "K9 gemm_kernel<0>", "K9 gemm_kernel<1>"}
    sass = sass_opcodes(native.BUILD_DIR / native.LIB_NAME, names)
    hmma = {name: sass.get(name, collections.Counter())["HMMA"] for name in sorted(names)}
    log("roofline", f"HMMA instructions in the SASS: {hmma} (K10 needs at least "
                    f"{2 * roofline.N_CHAINS}: {roofline.N_CHAINS} chains x 2 n-tiles per k-step)")
    if hmma["K10 roofline_kernel<4>"] < 2 * roofline.N_CHAINS:
        fail(f"K10's SASS has {hmma['K10 roofline_kernel<4>']} HMMA: its products were merged")
    matmul_peak = roofline.measure_xla_matmul_peak_tflops(size=MATMUL_PEAK_SIZE)
    res["matmul_tflops"] = matmul_peak
    datasheet = PEAK_BF16_FLOPS / 1e12
    log("roofline", f"measured bf16 tensor-core peaks: K10 mma.sync (size {ROOFLINE_SIZE}, "
                    f"{ROOFLINE_ITERS} iterations, {roofline.N_CHAINS} chains) {mxu:.1f} TFLOP/s, "
                    f"chained torch.matmul (size {MATMUL_PEAK_SIZE}) {matmul_peak:.1f} TFLOP/s; "
                    f"datasheet {datasheet:.0f} TFLOP/s (chip_smoke.bound keeps the datasheet)")
    if not 0 < mxu <= datasheet:
        fail(f"K10 measured {mxu:.1f} TFLOP/s, outside (0, {datasheet:.0f}]: its loop was cut")

    a, b = operands[0]
    m, n, kd = GEMM_SHAPES[0]
    res["k9"] = {"max_abs_err": k9_err, "ms": cuda_ms(lambda: gemm.matmul(a, b)),
                 "plain_ms": cuda_ms(lambda: gemm.matmul_reference(a, b), reps=3, trials=3),
                 **bound(tensor_bytes(a, b, outs[0]), 2.0 * m * n * kd),
                 "library_ms": cuda_ms(lambda: torch.matmul(a, b)),
                 "library_call": "torch.matmul (bf16)"}
    size, iters = ROOFLINE_SIZE, ROOFLINE_ITERS
    a, b = (torch.randn((size, size), generator=gen, device=DEVICE).to(torch.bfloat16)
            for _ in range(2))
    a4, b4 = (x.expand(roofline.N_CHAINS, size, size).contiguous() for x in (a, b))
    c0 = torch.zeros((roofline.N_CHAINS, size, size), dtype=torch.bfloat16, device=DEVICE)

    def chained_matmul():
        c = c0
        for _ in range(iters):
            c = torch.baddbmm(c, a4, b4, beta=1e-30)
        return c

    res["k10"] = {"max_abs_err": k10_err,
                  "ms": cuda_ms(lambda: roofline.roofline_call(a, b, iters=iters, size=size),
                                reps=3, trials=3),
                  "plain_ms": cuda_ms(lambda: roofline.roofline_reference(a, b, iters=iters),
                                      reps=1, trials=3),
                  **bound(3 * size * size * 2, 2.0 * size ** 3 * iters * roofline.N_CHAINS),
                  "library_ms": cuda_ms(chained_matmul, reps=1, trials=3),
                  "library_call": (f"{iters} chained torch.baddbmm of [{roofline.N_CHAINS}, "
                                   f"{size}, {size}] (beta 1e-30: the chains' feedback)")}
    for key, res_k in (("K9", res["k9"]), ("K10", res["k10"])):
        log("roofline", f"{key}: {res_k['ms']:.4f} ms, plain {res_k['plain_ms']:.4f} ms, bound "
                        f"{res_k['bound_ms']:.4f} ms ({res_k['bound_by']}), "
                        f"{res_k['library_call']} {res_k['library_ms']:.4f} ms")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import flashattn_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    def timed(phase):
        t0 = time.perf_counter()
        out = phase()
        log("time", f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    timed(phase_env)
    timed(phase_build)
    k1 = timed(phase_kernel_check)
    k1c = timed(phase_causal_check)
    k3 = timed(phase_bwd_check)
    seg = timed(phase_seg_check)
    launches = timed(phase_slice)
    k1c_launches, k3_launches = timed(phase_train)
    packed = timed(phase_packed_train)
    dec_k = timed(phase_decode_check)
    dec = timed(phase_decode)
    win = timed(phase_window_check)
    swa = timed(phase_swa_train)
    cap = timed(phase_softcap)
    bias = timed(phase_bias_check)
    bias_train = timed(phase_bias_train)
    roof = timed(phase_roofline)
    fwd_src, bwd_src, split_src, cap_src, win_src, cap_win_src, split_win_src, bias_src = (
        f"flashattn_tpu_torch/csrc/flash_{d}.cu"
        for d in ("fwd", "bwd", "bwd_split", "fwd_softcap", "fwd_window", "fwd_softcap_window",
                  "bwd_split_window", "bwd_split_bias"))
    decode_kernels = [
        {"name": f"flash_fwd {label} (K1 decode, {name} cache)", "route": "cuda",
         "source": f"flashattn_tpu_torch/csrc/flash_fwd_{src}.cu",
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115", "launches": dec[name][counter],
         **dec_k[name]}
        for name, label, src, counter in (("bf16", "bias", "bias", "K1 bias"),
                                          ("int8", "int8 K/V + bias", "int8", "K1 int8"),
                                          ("fp8", "fp8 K/V + bias", "fp8", "K1 fp8"))]
    print(json.dumps({"kernels": [
        {"name": "flash_fwd (K1)", "route": "cuda", "source": fwd_src,
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115", "launches": launches, **k1},
        {"name": "flash_fwd causal (K1 causal, K2)", "route": "cuda", "source": fwd_src,
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:516",
         "launches": k1c_launches, **k1c},
        {"name": "flash_fwd segments (K1 causal + segment ids)", "route": "cuda",
         "source": fwd_src, "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": packed["K1"], **seg["k1"]},
        {"name": "flash_bwd (K3, K4)", "route": "cuda", "source": bwd_src,
         "replaces": "flashattn_tpu/ops/flash_bwd_fused.py:110, "
                     "flashattn_tpu/ops/flash_bwd_fused.py:336",
         "launches": k3_launches, **k3},
        {"name": "flash_bwd_split dkv (K5)", "route": "cuda", "source": split_src,
         "replaces": "flashattn_tpu/ops/flash_bwd.py:139", "launches": packed["K5"], **seg["k5"]},
        {"name": "flash_bwd_split dq (K6)", "route": "cuda", "source": split_src,
         "replaces": "flashattn_tpu/ops/flash_bwd.py:234", "launches": packed["K6"],
         **seg["k6"]}, *decode_kernels,
        {"name": "flash_fwd window (K1 causal + sliding window, K2 windowed)", "route": "cuda",
         "source": win_src,
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:852",
         "launches": swa["K1 window"], **win["k1_window"]},
        {"name": "flash_bwd window (K3, K4 windowed)", "route": "cuda", "source": bwd_src,
         "replaces": "flashattn_tpu/ops/flash_bwd_fused.py:110, "
                     "flashattn_tpu/ops/flash_bwd_fused.py:651",
         "launches": swa["K3"], **win["k3_window"]},
        {"name": "flash_fwd softcap (K1 + logit softcap + sliding window)", "route": "cuda",
         "source": cap_win_src, "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": cap["train"]["K1 softcap"], **win["k1_softcap"]},
        {"name": "flash_bwd_split dkv softcap (K5 + logit softcap + sliding window)",
         "route": "cuda", "source": split_win_src,
         "replaces": "flashattn_tpu/ops/flash_bwd.py:139",
         "launches": cap["train"]["K5"], **win["k5_softcap"]},
        {"name": "flash_bwd_split dq softcap (K6 + logit softcap + sliding window)",
         "route": "cuda", "source": split_win_src,
         "replaces": "flashattn_tpu/ops/flash_bwd.py:234",
         "launches": cap["train"]["K6"], **win["k6_softcap"]},
        {"name": "flash_fwd softcap bias (K1 decode, soft-capped bf16 cache)", "route": "cuda",
         "source": cap_src, "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": cap["decode"]["K1 softcap"], **win["k1_softcap_bias"]},
        {"name": "flash_fwd bias (K1 + key-padding bias, path A)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/flash_fwd_bias.cu",
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": bias_train["mask"]["launches"]["K1 bias"], **bias["k1_bias"]},
        {"name": "flash_bwd_split dkv bias (K5 + bias)", "route": "cuda", "source": bias_src,
         "replaces": "flashattn_tpu/ops/flash_bwd.py:139",
         "launches": bias_train["mask"]["launches"]["K5 bias"], **bias["k5_bias"]},
        {"name": "flash_bwd_split dq bias (K6 + bias, no dbias)", "route": "cuda",
         "source": bias_src, "replaces": "flashattn_tpu/ops/flash_bwd.py:234",
         "launches": bias_train["mask"]["launches"]["K6 bias"], **bias["k6_bias"]},
        {"name": "flash_bwd_split dq dbias (K6 + bias + dbias, path A's learned arm)",
         "route": "cuda", "source": bias_src, "replaces": "flashattn_tpu/ops/flash_bwd.py:234",
         "launches": bias_train["learned"]["launches"]["K6 dbias"], **bias["k6_dbias"]},
        {"name": "gemm (K9)", "route": "cuda", "source": "flashattn_tpu_torch/csrc/gemm.cu",
         "replaces": "flashattn_tpu/ops/gemm.py:22", "launches": roof["launches"]["K9"],
         **roof["k9"]},
        {"name": "roofline (K10)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/roofline.cu",
         "replaces": "flashattn_tpu/ops/roofline.py:28", "launches": roof["launches"]["K10"],
         **roof["k10"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
