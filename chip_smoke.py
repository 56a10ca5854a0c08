"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``flashattn_tpu_torch/csrc/`` with nvcc (one
nvcc per source, in parallel) and holds each against its plain PyTorch version
at the shapes its paths give it: K1 non-causal (serving), K1 causal (which
also stands for K2) and K1 with segment ids on K1's dense route (a TMA +
wgmma forward, with wgmma and no mma.sync in its SASS), the backward K3
(which also stands for K4; TMA + wgmma too), the two-kernel backward K5
(dK/dV) + K6 (dQ) of packed and soft-capped training as one TMA + wgmma
launch (the split route, with wgmma and no mma.sync in its SASS), K1's
decode route (the split-KV decode kernel and its merge: bias, softcap +
bias, int8 / fp8 K/V, against its plain split / merge version and the dense
plain K1), the sliding-window and soft-capped variants of K1 (the cap on
its dense route too), K3 and the split route, K1's bias route (a TMA +
wgmma forward that streams the f32 bias through shared memory, with and
without the softcap, at every head dim up to 128, with wgmma and no
mma.sync in its SASS), K5 + K6 with a bias as one TMA + wgmma launch (the
bias route's backward: with and without dbias and the softcap, the GQA
decode fold's calls, every head dim up to 128), and the probes K9 (the
TMA + wgmma GEMM, with HGMMA and no HMMA in its SASS) and K10 (tensor-core
peak). Then it drives the port's paths and checks that each went through
its kernels:

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
  parameters, 16 layers, bf16) on a bf16, int8 and fp8 cache -- K1's decode
  kernel on bf16 K/V and dequantizing int8 / fp8 K/V in the kernel, over
  the live slots with no bias, checked first against their plain versions
  at bench_decode's attention shapes: gates against the teacher-forced
  forward and between cache dtypes, 8 requests per cache dtype (16 decode
  kernel launches per step, no dense K1), ms/token at cache lengths
  1024-8192; then the same LM in f32 served from an f32, an int8 and an fp8
  cache (the decode kernel's f32-q form, checked alone first; gates against
  the teacher-forced f32 forward and between cache dtypes, 2 x 8 requests
  per cache with exact launches, ms/token and peak memory at 1024-8192);
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
  steps per arm -- K1 on its bias route, K5 + K6 as its backward; first K1
  on its bias route and its backward at every bias shape they take (with
  and without the softcap, at D 40, 96 and 128, the decode fold's
  backward) against their plain versions, at the LM's attention shape with
  a learned [1, 16, 2048, 2048] bias, and flash_attention(bias=) end to end
  against autograd through the f32 oracle;
* the roofline probes (path B): K9 (gemm.matmul) at 4096^3 and K10
  (measure_mxu_peak_tflops) against their plain versions, K10's HMMA count in
  the SASS, and the measured mma.sync and chained torch.matmul peaks beside
  the datasheet's 989 TFLOP/s; then their f32 forms (six bf16 products per
  f32 product) against torch.matmul with TF32 off and roofline_reference,
  and the f32-accurate rates beside the 165 TFLOP/s the f32 bounds assume;
* sequence-parallel ring attention (context-parallel long-context training
  at the LM's attention width, 4 virtual ranks x 4096 tokens): forward and
  gradients through ring_attention_kernel_sharded with exactly 10 K7 and 10
  K8 launches causal (7 with a 2048-token window, 16 non-causal), against
  the plain ring and single-device K1 / K3, also at 8 ranks with GQA, at one
  rank, at D 64 and D 96 with a band edge inside the tiles, and through a
  one-rank NCCL process group; K7 and K8 (TMA + wgmma) with HGMMA, UTMALDG
  and no HMMA in their SASS;
* the distribution layer (context-parallel LM training on a (1, 2, 4)
  virtual mesh, 8 ranks on one card): K1's dense route and K3 / the split
  route with q / kv offsets at every chunk-pair kind against their plain
  versions; ring, zigzag, Ulysses and head-parallel attention against
  single-device flash_attention; the sharded LM step at full width in three
  layouts, its loss against the single-device lm_loss and its gradients
  against an f32 copy of the model, with exact launch counts;
* f32: the operand split into three bf16 pieces, as the f32 C entries
  launch it, against its plain version bit for bit (read back from their
  scratch); K1's f32 route and the f32 backward body (TMA + wgmma, six
  bf16 products per f32 product, with wgmma and TMA and no mma.sync in
  their SASS) against their plain versions with TF32 off at ragged shapes,
  GQA, causal, a window, segment ids, the cap and the ring's offsets; the
  reference's adversarial shape (B3 H7 N1537 D111 Nkv1234, D padded to 112)
  in bf16 and f32 through flash_attention; fp16 with
  ``compute_dtype=float32``; the LM of bench_lm.py at full width in f32
  (gates fused vs xla, 4 AdamW steps, unpacked and packed) with exact
  launches on the f32 kernels only;
* f32 with a bias: K1's f32 route and the f32 backward with an additive
  bias (TMA + wgmma on the pieces, the bias added in f32; dbias on request)
  against their plain versions with TF32 off at every bias broadcast shape,
  with ids, windows, offsets, the cap, GQA, ragged and decode shapes, dead
  rows and dbias exactly 0 where the masks drop pairs; f32 path A -- the
  attention module at its default float32 on x [4, 2048, 2048] with the
  key-padding mask, alone and with a trainable [1, 16, N, N] bias -- within
  1e-3 of the plain f32 function, a few AdamW steps each, with exact
  launches on the f32 bias kernels;
* head dims above 128: K1's dense route's D 256 form (TMA + wgmma, two
  (K, V) stages; with HGMMA and UTMALDG and no mma.sync in its SASS) at D
  160 / 136 / 256 with the cap, windows, ids, q / kv offsets, dead rows and
  one query row; K3's and the split route's D 256 form (TMA + wgmma, 64 keys
  a CTA, the two consumers splitting D; with HGMMA and UTMALDG and no
  mma.sync in their SASS) against their plain versions at D 256 / 192 /
  136, ragged, GQA, causal, windows, every ids kind, the cap, ids with the
  cap and K3 with offsets; then the LM of bench_lm.py with 8 query and 4 KV
  heads of 256 (Gemma 2's attention geometry) training unpacked, with
  logit_softcap 50 and packed, each with the fused-vs-xla gates and exact
  launches on the D 256 forms, and its contiguous sharded step on a (1, 1,
  4) virtual mesh (K1 and K3 with q / kv offsets at D 256);
* the port's entry points (``flashattn_tpu_torch/entry.py``): ``entry()``'s
  U-Net denoise step and ``dryrun_multichip(8)`` (the f32 LM on a virtual
  8-rank mesh, contiguous, packed and two slices);
* the composition fuzz's card arm: ``utils/testing.sample_composition``'s
  draws (every option of ``flash_attention`` jointly) through the kernels
  against autograd through the port's oracle, until every route has been
  reached; a refusal only under the labels still open.

Every kernel's line in the kernels JSON carries its time, its plain version's
time, its bound (the larger of the bytes it must move at 3.35 TB/s and its
tensor-core FLOPs at 989 TFLOP/s, the H100 SXM's datasheet peaks; the f32
kernels' FLOPs at 165 TFLOP/s, the bf16 peak over six) and the
time of one PyTorch call that computes the same function
(``scaled_dot_product_attention``, forward or backward; ``flex_attention``
compiled by ``torch.compile`` where a softcap or segment ids rule SDPA out),
or null with the reason where none does (quantized K/V). Those compiled
afresh in every run for rows it does not change -- compiled flex_attention,
SDPA at each fused backend -- run with ``--yardsticks`` (YARDSTICKS); by
default the flex rows' library time is null ("not timed") and SDPA runs at
its own choice of backend.

One line per phase; the last two lines are a JSON object of the kernels'
numbers and ``{"ok": true, "device": ...}``. Exits non-zero, before printing
any result, when there is no CUDA device or when any phase fails. Imports
nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import pathlib
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
F32_LSE_ATOL = 1e-4  # an f32 q's LSE (FWD_TOL[f32]'s atol)
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
# The least time of an f32-accurate product: six bf16 products of three-piece
# operands at the bf16 peak, 989 / 6 TFLOP/s -- the dense TF32 peak (495
# TFLOP/s) over three, 3xTF32's rate, to 0.1%, the value kept since the f32
# kernels' first rows (a single TF32 or bf16 pass keeps ~3 decimal digits;
# FFMA peaks at 67 TFLOP/s).
PEAK_F32_ACCURATE_FLOPS = 495e12 / 3
# phase_build's ptxas report ({instantiation: (registers, stack, spill
# stores, spill loads)}), read again where a phase logs a kernel's registers.
BUILD_STATS: dict = {}


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


# Cycles a second that queued_ms assumes to size its sleep kernel (the H100's
# top clock, 1980 MHz): at a lower clock the backlog only lasts longer.
SLEEP_CYCLES_PER_MS = 1.98e6


def queued_ms(fn, *, reps: int = 20, trials: int = 5, backlog_ms: float = 100.0) -> float:
    """Median over ``trials`` of the mean CUDA-event time of ``reps`` calls of
    ``fn`` enqueued behind a sleep kernel of ``backlog_ms``: the card is busy
    while the host enqueues them, so the events read the calls' kernels and
    the card's gaps between them, not the host's time per call (which
    cuda_ms reads where it exceeds the kernels'). A trial whose enqueueing
    outlasted its backlog is run again behind a backlog twice as long, twice
    at most; past that (a call that waits for the card) cuda_ms's reading,
    said in the log."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < trials:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(backlog_ms * SLEEP_CYCLES_PER_MS))
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host >= 0.8 * ev[0].elapsed_time(ev[1]):
            backlog_ms *= 2
            if backlog_ms > 400.0:
                log("timing", f"queued_ms: {reps} calls took the host {host:.1f} ms, longer "
                              f"than their backlog: their CUDA-event time without one instead")
                return cuda_ms(fn, reps=reps, trials=trials)
            continue
        times.append(ev[1].elapsed_time(ev[2]) / reps)
    return statistics.median(times)


def tensor_bytes(*xs) -> int:
    """Bytes of the given tensors (None counts 0): each read or written once."""
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over the
    HBM rate and ``flops`` over ``peak_flops`` (the bf16 tensor-core rate by
    default; PEAK_F32_ACCURATE_FLOPS for f32-accurate products), and which
    one."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / peak_flops * 1e3
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


# The library yardsticks that are compiled afresh in every run -- flex_attention
# by torch.compile (each call a compile of its own) and SDPA at each fused
# backend -- time rows that a run of the kernels they stand beside does not
# change. They run with ``python3 chip_smoke.py --yardsticks`` (main sets
# this); by default flex_ms gives None (the row's library_ms null, logged as
# "not timed") and _sdpa_backends_ms times SDPA at its own choice of backend
# alone. Every gate, and every kernel timing a gate reads, runs either way.
YARDSTICKS = False
# Seconds spent in each yardstick kind this run (main prints them).
YARDSTICK_SECONDS = {"flex_attention compiled": 0.0, "SDPA backends": 0.0}


def ms_text(ms) -> str:
    """A library time as the logs print it: ms to 4 places, or why none."""
    return "not timed (python3 chip_smoke.py --yardsticks)" if ms is None else f"{ms:.4f}"


def sdpa_ms(q, k, v, *, do=None, bias_leaf=None, backend=None, device: bool = False,
            **kw) -> float:
    """The library yardstick: one ``scaled_dot_product_attention`` call at
    its best backend (or, given ``backend``, a ``torch.nn.attention.
    SDPBackend``, at that one) on the same inputs (``enable_gqa`` for Hkv <
    Hq), or, with ``do``, the one backward call of that attention (dQ, dK, dV
    from the saved forward, and the gradient of ``bias_leaf``, a tensor that
    requires grad and from which ``attn_mask`` was computed: SDPA's dbias).
    Its CUDA-event time, or with ``device`` the device time of its kernels
    alone (kernels_ms). Timed here, used nowhere in the port."""
    import contextlib

    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    only = contextlib.nullcontext() if backend is None else sdpa_kernel(backend)
    kw.setdefault("enable_gqa", k.shape[1] != q.shape[1])
    if do is None:
        with torch.no_grad(), only:
            fn = lambda: F.scaled_dot_product_attention(q, k, v, **kw)  # noqa: E731
            return kernels_ms(fn) if device else cuda_ms(fn, reps=5, trials=3)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    with only:
        out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
    leaves = (qg, kg, vg) + (() if bias_leaf is None else (bias_leaf,))
    fn = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
    return kernels_ms(fn) if device else cuda_ms(fn, reps=5, trials=3)


PROFILE_RUNS = 5
# Set once every run of a _profiled call recorded no kernel at all: CUPTI
# had stopped recording, and on the H100 it has not recovered later in the
# same process (PR 24: 31 reads in a row), so later calls make one run.
_CUPTI_SILENT = []


def _profiled(fn, reps: int, enough) -> list:
    """The key_averages() of a torch.profiler run over CUDA activity in
    ``reps`` calls of ``fn`` (after one call outside it), run again after a
    pause, PROFILE_RUNS runs at most (one once CUPTI has gone silent,
    _CUPTI_SILENT), while ``enough`` of them is false: in a process that
    ran the profiler before, CUPTI can drop some launches of a run, or all
    of them (0 of 20 seen on an H100, in three runs in a row once)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for run in range(1 if _CUPTI_SILENT else PROFILE_RUNS):
        if run:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = list(prof.key_averages())
        if enough(events):
            return events
    if not any(_self_device_us(e) > 0 for e in events):
        _CUPTI_SILENT.append(True)
    return events


def _self_device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return getattr(e, "self_cuda_time_total", 0.0) if t is None else t


def kernels_ms(fn, reps: int = 20) -> float:
    """Device ms of one call of ``fn`` in its kernels alone, the host's time
    between them left out: from a torch.profiler run over CUDA activity in
    ``reps`` calls (_profiled), each kernel's mean device time times its
    launches a call (its count over ``reps``, rounded: the profiler can miss
    a launch), summed. Where the profiler records no kernel in any of its
    runs, the calls' CUDA-event time behind a backlog (queued_ms: the
    kernels and the card's gaps between them), said in the log."""
    events = _profiled(fn, reps, lambda ev: any(_self_device_us(e) > 0 for e in ev))
    total = sum(_self_device_us(e) / e.count * max(1, round(e.count / reps))
                for e in events if _self_device_us(e) > 0 and e.count > 0)
    if total <= 0:
        ms = queued_ms(fn, reps=reps, trials=3)
        log("profiler", f"recorded no kernel of the call in "
                        f"{1 if len(_CUPTI_SILENT) > 1 else PROFILE_RUNS} run(s): its CUDA-event "
                        f"time behind a backlog instead, {ms:.4f} ms (the kernels and the card's "
                        f"gaps between them)")
        return ms
    return total / 1e3


def host_ms(fn, *, reps: int = 200, trials: int = 5) -> float:
    """The host's own ms per call of ``fn``: median over ``trials`` of the
    host clock over ``reps`` calls enqueued back to back, the card
    synchronized before and after the clock but not within it. Where it
    exceeds the kernel's device time, cuda_ms reads the host's time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
    return statistics.median(times)


def host_profile(fn, *, reps: int = 200, top: int = 8) -> list:
    """cProfile of ``reps`` calls of ``fn`` (after a warm-up): the ``top``
    functions by their own host time, as (name, calls, own ms a call of
    ``fn``). cProfile's own overhead inflates each entry; their order is the
    reading."""
    import cProfile
    import pstats

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = [(f"{'/'.join(f.split(os.sep)[-2:])}:{line}({name})", calls, tt * 1e3 / reps)
            for (f, line, name), (_, calls, tt, _, _) in pstats.Stats(prof).stats.items()]
    return sorted(rows, key=lambda r: -r[2])[:top]


def flex_ms(q, k, v, *, scale: float, do=None, score_mod=None, mask_mod=None) -> float:
    """The library yardstick where no SDPA call computes the function (a
    logit softcap, segment ids): one call of ``flex_attention`` compiled by
    ``torch.compile`` (Triton), with ``score_mod`` and the block mask of
    ``mask_mod``, on contiguous copies of the same inputs; with ``do``, its
    one backward call (dQ, dK and dV together). The warm-up compiles it
    (Inductor's and Triton's caches go to the port's build directory). Timed
    here, used nowhere in the port. None unless YARDSTICKS."""
    if not YARDSTICKS:
        return None
    from torch._functorch import config as functorch_config

    t0 = time.perf_counter()
    flex, block = _compiled_flex(q, k, mask_mod)
    kw = dict(score_mod=score_mod, block_mask=block, scale=scale,
              enable_gqa=k.shape[1] != q.shape[1])
    q, k, v = (x.contiguous() for x in (q, k, v))
    if do is None:
        with torch.no_grad():
            ms = cuda_ms(lambda: flex(q, k, v, **kw), reps=5, trials=3)
    else:
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        # The one graph's backward is timed again and again (retain_graph), which
        # a compiled backward that donates its saved buffers refuses.
        with functorch_config.patch(donated_buffer=False):
            out = flex(qg, kg, vg, **kw)
            ms = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
                         reps=5, trials=3)
    YARDSTICK_SECONDS["flex_attention compiled"] += time.perf_counter() - t0
    return ms


def _compiled_flex(q, k, mask_mod):
    """flex_attention compiled afresh by torch.compile (Inductor's and
    Triton's caches in the port's build directory) and the block mask of
    ``mask_mod`` (None without one) at these shapes. Afresh: past dynamo's
    recompile limit on flex_attention's code a compiled call would quietly
    run eager."""
    from flashattn_tpu_torch.utils import native

    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(native.BUILD_DIR / sub))
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    torch._dynamo.reset()
    block = None if mask_mod is None else create_block_mask(
        mask_mod, q.shape[0], None, q.shape[2], k.shape[2], device=q.device)
    return torch.compile(flex_attention), block


def flex_fwd_bwd_ms(q, k, v, do, *, scale: float, score_mod=None, mask_mod=None) -> tuple:
    """flex_ms's forward and backward times from one compile: the compiled
    flex_attention on inputs that require grad (the training graph, whose
    forward is what the backward then differentiates), its forward call
    timed as it is, then its one backward call (dQ, dK and dV). Timed here,
    used nowhere in the port. (None, None) unless YARDSTICKS."""
    if not YARDSTICKS:
        return None, None
    from torch._functorch import config as functorch_config

    t0 = time.perf_counter()
    flex, block = _compiled_flex(q, k, mask_mod)
    kw = dict(score_mod=score_mod, block_mask=block, scale=scale,
              enable_gqa=k.shape[1] != q.shape[1])
    qg, kg, vg = (x.contiguous().detach().requires_grad_(True) for x in (q, k, v))
    with functorch_config.patch(donated_buffer=False):
        fwd = cuda_ms(lambda: flex(qg, kg, vg, **kw), reps=5, trials=3)
        out = flex(qg, kg, vg, **kw)
        bwd = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
                      reps=5, trials=3)
    YARDSTICK_SECONDS["flex_attention compiled"] += time.perf_counter() - t0
    return fwd, bwd


def softcap_mod(cap: float, bias=None):
    """flex_attention's ``score_mod`` of K1's softcap: ``cap·tanh(s/cap)`` on
    the scaled score, then ``bias [B|1, H|1, Nq|1, Nk]`` (the HF Gemma-2
    order, flash_fwd.py:310-318)."""
    def mod(score, b, h, q_idx, kv_idx):
        score = cap * torch.tanh(score / cap)
        if bias is None:
            return score
        i = [x if n > 1 else 0 for x, n in zip((b, h, q_idx), bias.shape[:3])]
        return score + bias[i[0], i[1], i[2], kv_idx]
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


def _card_state() -> str:
    """The card's SM clock (now and its maximum), power draw and temperature,
    as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _card_name() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_env() -> None:
    print(_card_name(), flush=True)
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
    BUILD_STATS.update(stats)
    for name, (regs, stack, spill_st, spill_ld) in stats.items():
        log("build", f"{name}: {regs} registers, {stack} B stack frame, {spill_st} B spill "
                     f"stores, {spill_ld} B spill loads")
    log("build", f"{len(stats)} kernel instantiations")
    # ptxas's notes of wgmma serialized (C7518-C7520): logged for every
    # instantiation; the f32 backward body's must have none (its chains issue
    # back to back, csrc/flash_bwd_f32.cu), nor K1's forward body's D 256
    # forms (its overlapped loop issues S and P V without a branch,
    # csrc/fwd_sm90_tile.cuh).
    notes = serialization_notes(out)
    for name, found in sorted(notes.items()):
        for code, why in found:
            log("build", f"{name}: ({code}) wgmma serialized: {why}")
    for label, names in (("the f32 backward body", sorted(n for n in stats
                                                          if "bwd_f32_kernel" in n)),
                         ("the D 256 forward body", fwd_d256_instantiations(stats))):
        log("build", f"wgmma serialization notes: {sum(map(len, notes.values()))} in "
                     f"{len(notes)} instantiations; {label}'s {len(names)} instantiations: "
                     f"{sum(n in notes for n in names)} with one")
        if any(n in notes for n in names):
            fail(f"ptxas serialized the wgmma of {label}: "
                 + "; ".join(f"{n}: {notes[n]}" for n in names if n in notes))


def fwd_d256_instantiations(names) -> list:
    """Of ``names`` (instantiation_name's), the D 256 instantiations of K1's
    forward body fwd_sm90_tile.cuh::fwd_sm90_body: K1's dense route's and bias
    route's D 256 forms and K7's D 256 form."""
    return sorted(n for n in names if "fwd_dense_sm90_kernel<256" in n
                  or "fwd_bias_sm90_kernel<256" in n or "ring_fwd_wide_kernel" in n)


def serialization_notes(out: str) -> dict:
    """ptxas's "wgmma.mma_async instructions are serialized" notes in ``-v``
    output as {instantiation_name: [(code, reason), ...]}, e.g. ``("C7520",
    "program dependence on compiler-inserted WG.AR in divergent path")``."""
    notes = {}
    for m in re.finditer(r"\((C75\d\d)\) Potential Performance Loss: wgmma\.mma_async "
                         r"instructions are serialized due to (.*?) in the function '([^']+)'",
                         out):
        notes.setdefault(instantiation_name(m.group(3)), []).append((m.group(1), m.group(2)))
    return notes


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
    """The kernel (K1 and its variant, K1's decode, bias and dense routes,
    K3, K5, K6, K5 + K6's bias route, the f32 routes, K7-K10) and template
    arguments of a mangled instantiation name from ptxas, e.g. ``K1 f32
    segments fwd_f32_kernel<128, 1, 0>``, ``K1 f32 d256 bias
    fwd_f32_wide_kernel<0, 0, 1>``, ``bwd f32 softcap
    bwd_f32_kernel<64, 0, 1>``, ``K1 int8 bias
    fwd_kernel<128, 1, 1>``, ``K1 decode fp8 bias decode_kernel<128, 2, 1,
    0>``, ``K1 bias sm90 softcap fwd_bias_sm90_kernel<128, 1>``, ``K1 dense
    sm90 segments fwd_dense_sm90_kernel<128, 1, 0>``, ``K3 sm90
    bwd_sm90_kernel<64>``, ``bias bwd sm90 softcap
    bwd_bias_sm90_kernel<128, 1, 1>``, ``bias bwd sm90 d256 segments
    bwd_bias_wide_kernel<1, 0>``,
    ``K5 + K6 split sm90 segments softcap bwd_split_sm90_kernel<128, 1, 1>``
    or ``K5 softcap bias dkv_bias_kernel<128, 1>`` (K9 is
    ``gemm_wgmma_kernel``, K7 / K8 ``ring_{fwd,bwd}_sm90_kernel``; the
    earlier ``gemm_kernel``, ``ring_{fwd,bwd}_kernel`` and K5 / K6 without a
    bias (``dkv_kernel``, ``dq_softcap_kernel``, ``dkv_window_kernel``, ...)
    are still named, for chip_ab.py's parent builds, as are the Hopper
    kernels of a parent before they took the softcap, with one template
    argument fewer); an unrecognised name comes back marked as such, never
    raising."""
    if "decode_merge_kernel" in mangled:
        return "K1 decode merge decode_merge_kernel"
    if "split_bf16x3_kernel" in mangled:  # the f32 routes' operand split
        return "split bf16x3 split_bf16x3_kernel"
    dec = re.search(r"decode_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if dec:  # K1's decode route: decode_kernel<D, KV, BIAS, CAP, F32Q> (F32Q 0 named
        # without it, as before the f32-q form)
        args = [int(a) for a in re.findall(r"L[a-z]+(-?\d+)E", dec.group(1))]
        f32q = len(args) == 5 and args[4] == 1
        args = args[:4] if len(args) == 5 and not f32q else args
        label = f"decode_kernel<{', '.join(map(str, args))}>"
        if len(args) != 4 + f32q:
            return f"unrecognised instantiation {label}"
        variant = {0: "", 1: " int8", 2: " fp8"}.get(args[1], f" kv{args[1]}")
        return (f"K1 decode{' f32' if f32q else ''}{variant}{' softcap' if args[3] else ''}"
                f"{' bias' if args[2] else ''} {label}")
    quant_f32 = re.search(r"fwd_quant_f32_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if quant_f32:  # K1's quantized route on an f32 q, fwd_quant_f32_kernel<D, KV, BIAS, SEG>
        args = re.findall(r"L[a-z]+(-?\d+)E", quant_f32.group(1))
        label = f"fwd_quant_f32_kernel<{', '.join(args)}>"
        if len(args) != 4:
            return f"unrecognised instantiation {label}"
        variant = {"1": " int8", "2": " fp8"}.get(args[1], f" kv{args[1]}")
        return (f"K1 quant f32{variant}{' bias' if args[2] == '1' else ''}"
                f"{' segments' if args[3] == '1' else ''} {label}")
    gemm_f32 = re.search(r"gemm_f32_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if gemm_f32:  # K9's f32 form, gemm_f32_kernel<OUT_F32>
        args = re.findall(r"L[a-z]+(-?\d+)E", gemm_f32.group(1))
        return f"K9 f32 gemm_f32_kernel<{', '.join(args)}>"
    roof = re.search(r"roofline_kernelILi(\d+)E(f|13__nv_bfloat16)E", mangled)
    if roof:  # K10, roofline_kernel<CHAINS, T>: bf16 named as before its f32 form
        return (f"K10 f32 roofline_kernel<{roof.group(1)}, float>" if roof.group(2) == "f"
                else f"K10 roofline_kernel<{roof.group(1)}>")
    quant_sm90 = re.search(r"fwd_quant_sm90_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if quant_sm90:  # K1's quantized route, fwd_quant_sm90_kernel<D, KV, BIAS, SEG>
        args = re.findall(r"L[a-z]+(-?\d+)E", quant_sm90.group(1))
        label = f"fwd_quant_sm90_kernel<{', '.join(args)}>"
        if len(args) != 4:
            return f"unrecognised instantiation {label}"
        variant = {"1": " int8", "2": " fp8"}.get(args[1], f" kv{args[1]}")
        return (f"K1 quant sm90{variant}{' bias' if args[2] == '1' else ''}"
                f"{' segments' if args[3] == '1' else ''} {label}")
    dense_sm90 = re.search(r"fwd_dense_sm90_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if dense_sm90:  # K1's dense route, fwd_dense_sm90_kernel<D, SEG, CAP>
        args = re.findall(r"L[a-z]+(-?\d+)E", dense_sm90.group(1))
        seg = " segments" if len(args) >= 2 and args[1] == "1" else ""
        cap = " softcap" if len(args) == 3 and args[2] == "1" else ""
        return f"K1 dense sm90{seg}{cap} fwd_dense_sm90_kernel<{', '.join(args)}>"
    wide_ring = re.search(r"ring_(fwd|bwd)_wide_kernel", mangled)
    if wide_ring:  # K7 / K8's D 256 forms (K1's dense body, K3's D 256 body)
        return (f"{'K7' if wide_ring.group(1) == 'fwd' else 'K8'} d256 "
                f"ring_{wide_ring.group(1)}_wide_kernel")
    f32_wide = re.search(r"fwd_f32_wide_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if f32_wide:  # K1's f32 route's D 256 form, fwd_f32_wide_kernel<SEG, CAP, BIAS, RING>
        # (RING 1: K7's f32 D 256 form; RING 0 is named as before it existed)
        args = re.findall(r"L[a-z]+(-?\d+)E", f32_wide.group(1))
        label = f"fwd_f32_wide_kernel<{', '.join(args)}>"
        if len(args) == 4 and args[3] == "1":
            return f"K7 f32 d256 {label}"
        args = args[:3] if len(args) == 4 else args
        label = f"fwd_f32_wide_kernel<{', '.join(args)}>"
        if len(args) != 3:
            return f"unrecognised instantiation {label}"
        return (f"K1 f32 d256{' bias' if args[2] == '1' else ''}"
                f"{' segments' if args[0] == '1' else ''}{' softcap' if args[1] == '1' else ''} "
                f"{label}")
    f32 = re.search(r"(fwd|bwd)_f32_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if f32:  # the f32 routes, fwd_f32_kernel / bwd_f32_kernel<DB, SEG, CAP, BIAS, RING> (RING
        # 1: K7's / K8's f32 forms; RING 0 named without it, as a parent's
        # <DB, SEG, CAP, BIAS>, or <DB, SEG, CAP> before the bias)
        args = re.findall(r"L[a-z]+(-?\d+)E", f32.group(2))
        if len(args) == 5 and args[4] == "1":
            return (f"{'K7' if f32.group(1) == 'fwd' else 'K8'} f32 "
                    f"{f32.group(1)}_f32_kernel<{', '.join(args)}>")
        args = args[:4] if len(args) == 5 else args
        if len(args) not in (3, 4):
            return f"unrecognised instantiation {f32.group(1)}_f32_kernel<{', '.join(args)}>"
        return (f"{'K1 f32' if f32.group(1) == 'fwd' else 'bwd f32'}"
                f"{' bias' if len(args) == 4 and args[3] == '1' else ''}"
                f"{' segments' if args[1] == '1' else ''}{' softcap' if args[2] == '1' else ''} "
                f"{f32.group(1)}_f32_kernel<{', '.join(args)}>")
    k3_sm90 = re.search(r"\d(?:bwd_sm90_kernel)I((?:L[a-z]+-?\d+E)+)E", mangled)
    if k3_sm90:  # K3 on Hopper, bwd_sm90_kernel<D> (not ring_bwd_sm90_kernel)
        args = re.findall(r"L[a-z]+(-?\d+)E", k3_sm90.group(1))
        return f"K3 sm90 bwd_sm90_kernel<{', '.join(args)}>"
    bias_sm90 = re.search(r"fwd_bias_sm90_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if bias_sm90:  # K1's bias route, fwd_bias_sm90_kernel<D, SEG, CAP> (<D, CAP> before ids)
        args = re.findall(r"L[a-z]+(-?\d+)E", bias_sm90.group(1))
        seg = " segments" if len(args) == 3 and args[1] == "1" else ""
        cap = " softcap" if len(args) in (2, 3) and args[-1] == "1" else ""
        return f"K1 bias sm90{seg}{cap} fwd_bias_sm90_kernel<{', '.join(args)}>"
    split = re.search(r"bwd_split_sm90_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if split:  # K5 + K6 without a bias, bwd_split_sm90_kernel<D, SEG, CAP>
        args = re.findall(r"L[a-z]+(-?\d+)E", split.group(1))
        if len(args) != 3:
            return f"unrecognised instantiation bwd_split_sm90_kernel<{', '.join(args)}>"
        return (f"K5 + K6 split sm90{' segments' if args[1] == '1' else ''}"
                f"{' softcap' if args[2] == '1' else ''} "
                f"bwd_split_sm90_kernel<{', '.join(args)}>")
    bias_wide = re.search(r"bwd_bias_wide_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if bias_wide:  # K5 + K6's bias route at D 256, bwd_bias_wide_kernel<SEG, CAP>
        args = re.findall(r"L[a-z]+(-?\d+)E", bias_wide.group(1))
        if len(args) != 2:
            return f"unrecognised instantiation bwd_bias_wide_kernel<{', '.join(args)}>"
        return (f"bias bwd sm90 d256{' segments' if args[0] == '1' else ''}"
                f"{' softcap' if args[1] == '1' else ''} "
                f"bwd_bias_wide_kernel<{', '.join(args)}>")
    bias_bwd = re.search(r"bwd_bias_sm90_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if bias_bwd:  # K5 + K6's bias route, bwd_bias_sm90_kernel<D, DBIAS, CAP, SEG>
        args = re.findall(r"L[a-z]+(-?\d+)E", bias_bwd.group(1))
        seg = " segments" if len(args) == 4 and args[3] == "1" else ""
        cap = " softcap" if len(args) in (3, 4) and args[2] == "1" else ""
        return f"bias bwd sm90{seg}{cap} bwd_bias_sm90_kernel<{', '.join(args)}>"
    wgmma = re.search(r"gemm_wgmma_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if wgmma:  # K9, gemm_wgmma_kernel<OUT_F32>
        args = re.findall(r"L[a-z]+(-?\d+)E", wgmma.group(1))
        return f"K9 gemm_wgmma_kernel<{', '.join(args)}>"
    ring90 = re.search(r"ring_(fwd|bwd)_sm90_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if ring90:  # K7 / K8 as TMA + wgmma kernels, ring_{fwd,bwd}_sm90_kernel<D>
        args = re.findall(r"L[a-z]+(-?\d+)E", ring90.group(2))
        return (f"{'K7' if ring90.group(1) == 'fwd' else 'K8'} "
                f"ring_{ring90.group(1)}_sm90_kernel<{', '.join(args)}>")
    ring = re.search(r"ring_(fwd|bwd)_kernelI((?:L[a-z]+-?\d+E)+)E", mangled)
    if ring:  # the mma.sync K7 / K8 of a parent's csrc/ring.cu; before the K1
        # pattern, which "ring_fwd_kernel" would also match
        args = re.findall(r"L[a-z]+(-?\d+)E", ring.group(2))
        return (f"{'K7' if ring.group(1) == 'fwd' else 'K8'} "
                f"ring_{ring.group(1)}_kernel<{', '.join(args)}>")
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
    # Template arguments after DP, by kernel: K1 fwd_kernel<DP, BIAS, KV> and
    # fwd_softcap_kernel<DP> (a bias implied), and in a parent before the
    # dense route's D 256 form fwd_kernel<DP, SEG, BIAS, KV>,
    # fwd_softcap_kernel<DP, SEG, BIAS>, fwd_window_kernel<DP, SEG, CAP>; K5
    # dkv_kernel<DP>, dkv_softcap_kernel<DP>, dkv_window_kernel<DP, CAP> (and,
    # in a parent that had the mma.sync K3, dkv_kernel<DP, DQ> and
    # dkv_window_kernel<DP, DQ, CAP>); K6 dq_kernel<DP>, dq_softcap_kernel<DP>,
    # dq_window_kernel<DP, CAP>; K5/K6 with a bias dkv_bias_kernel<DP, CAP>,
    # dq_bias_kernel<DP, CAP>. The TMA + wgmma kernels: above.
    params = {("fwd", ""): ("seg", "bias", "kv"), ("fwd", "_softcap"): ("seg", "bias"),
              ("fwd", "_window"): ("seg", "cap"), ("dkv", ""): (), ("dkv", "_softcap"): (),
              ("dkv", "_window"): ("cap",), ("dkv", "_bias"): ("cap",), ("dq", ""): (),
              ("dq", "_softcap"): (), ("dq", "_window"): ("cap",),
              ("dq", "_bias"): ("cap",)}.get((kind, family))
    if kind == "dkv" and family in ("", "_window") and len(args) == 2 + len(params):
        params = ("dq", *params)
    if kind == "fwd" and family in ("", "_softcap") and len(args) == len(params):
        params = params[1:]  # no SEG
    if kind == "fwd" and family == "_softcap" and len(args) == 1:
        params = ()
    if params is None or len(args) != 1 + len(params):
        return f"unrecognised instantiation {label}"
    a = dict(zip(params, args[1:]))
    if kind == "fwd" and family == "_softcap" and not params:
        a["bias"] = 1
    cap = family == "_softcap" or a.get("cap")
    window = family == "_window"
    if kind == "fwd":
        variant = {0: "", 1: " int8", 2: " fp8"}.get(a.get("kv", 0), f" kv{a.get('kv')}")
        return (f"K1{variant}{' softcap' if cap else ''}{' window' if window else ''}"
                f"{' bias' if a.get('bias') else ''}{' segments' if a.get('seg') else ''} {label}")
    name = "K6" if kind == "dq" else "K3" if a.get("dq") else "K5"
    return (f"{name}{' softcap' if cap else ''}{' window' if window else ''}"
            f"{' bias' if family == '_bias' else ''} {label}")


def sass_opcodes(lib, names: set) -> dict:
    """{instantiation name: Counter of SASS opcodes} for the kernels of the
    library ``lib`` named in ``names`` (:func:`instantiation_name`), from
    ``cuobjdump -sass`` (read once per build of the library: _sass_counts)."""
    lib = pathlib.Path(lib)
    counts = _sass_counts(str(lib), lib.stat().st_mtime if lib.exists() else None)
    return {n: c for n, c in counts.items() if n in names}


@functools.lru_cache(maxsize=4)
def _sass_counts(lib: str, mtime) -> dict:
    """{instantiation name: Counter of SASS opcodes} of every kernel of the
    library ``lib`` as built at ``mtime`` (its modification time): one
    ``cuobjdump -sass`` and one parse, which the phases that read the SASS
    share."""
    from flashattn_tpu_torch.utils import native

    cuobjdump = os.path.join(os.path.dirname(native.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    ops, current = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            current = ops.setdefault(instantiation_name(fn.group(1)), collections.Counter())
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
        before = _launches()
        o, lse = flash_fwd.fwd(q, k, v, scale=D ** -0.5)
        torch.cuda.synchronize()
        # K1's dense route; D 160 on its D 256 form.
        _routed(f"K1 at {name}", before, K1=1, K1_dense_sm90=1, K1_dense_d256=int(D > 128))
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
        before = _launches()
        o, lse = flash_fwd.fwd(q, k, v, scale=D ** -0.5, causal=True)
        torch.cuda.synchronize()
        _routed(f"K1 causal at {name}", before, K1=1, K1_dense_sm90=1)
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
    the same LSE and Delta (from the f32 forward), one launch of its Hopper
    kernel each. Budget BWD_TOL[bf16] per element on dQ, dK and dV: the
    kernel feeds P and dS to the tensor cores in bf16, and its dQ bulk
    reductions add in an order that changes from run to run. Then, after
    those numeric gates, the SASS of K1's dense route and of K3
    (_tma_wgmma_sass): wgmma and TMA, no mma.sync."""
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
        before = _launches()
        got = flash_bwd_fused.bwd(q, k, v, do, lse, delta, scale=scale, causal=causal,
                                  kv_valid_len=kvl)
        torch.cuda.synchronize()
        _routed(f"K3 at {name}", before, K3=1, K3_sm90=1)
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
    # In: q, k, v, dO (bf16), LSE, Delta (f32); out: dQ, dK, dV as the
    # function returns them (bf16; dK / dV at Hkv heads).
    res.update(bound(tensor_bytes(q, k, v, do, *args[4:]) + tensor_bytes(q, k, v), tf * 1e9))
    res["library_ms"] = sdpa_ms(q, k, v, do=do, is_causal=True)
    res["library_call"] = "the backward of scaled_dot_product_attention(is_causal=True)"
    log("kernel", f"lm shape B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal bf16: K3 {res['ms']:.4f} ms "
                  f"({tf / res['ms']:.1f} TFLOP/s), plain version {res['plain_ms']:.4f} ms "
                  f"({tf / res['plain_ms']:.1f} TFLOP/s), bound {res['bound_ms']:.4f} ms, SDPA "
                  f"backward {res['library_ms']:.4f} ms (median CUDA-event time)")
    _tma_wgmma_sass("kernel", {f"K1 dense sm90{' segments' if seg else ''}"
                               f"{' softcap' if cap else ''} "
                               f"fwd_dense_sm90_kernel<{d}, {seg}, {cap}>"
                               for d in (64, 128) for seg in (0, 1) for cap in (0, 1)}
                    | {f"K3 sm90 bwd_sm90_kernel<{d}>" for d in (64, 128)})
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
    if kind == "alternate":
        # The f32 backward's 32-row Q tiles in turn ids 0 and 1, every key 0:
        # each KV tile's walk skips every other Q tile (their rows are dead).
        from flashattn_tpu_torch.ops.flash_bwd import F32_BWD_Q_TILE

        rows = torch.arange(Nq, device=DEVICE) // F32_BWD_Q_TILE % 2
        return (rows.to(torch.int32).expand(B, Nq).contiguous(),
                torch.zeros((B, Nk), dtype=torch.int32, device=DEVICE))
    seg_q = torch.zeros((B, Nq), dtype=torch.int32, device=DEVICE)
    seg_q[:, Nq // 2:] = 7
    return seg_q, torch.zeros((B, Nk), dtype=torch.int32, device=DEVICE)


def phase_seg_check() -> dict:
    """K1 with segments and K5 + K6's split route (flash_bwd.split_bwd: one
    launch for both) against their plain versions on f32 copies of the same
    bf16 inputs (the backward with the LSE and Delta of the f32 forward): O
    within FWD_TOL[bf16], LSE within 1e-3 on live rows, dQ/dK/dV within
    BWD_TOL[bf16]; the dead rows' O and dQ exactly 0; each call through its
    route, exactly once. Times both at bench_lm's packed shape beside their
    plain versions, flex_attention and its backward, prints, ungated, K1 with
    segments against K1 causal there and the split route against K3 causal
    without segments, and checks the split route's SASS (HGMMA, UTMALDG, no
    HMMA)."""
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
        before = _launches()
        o, lse = flash_fwd.fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        _routed(f"K1 with segments at {name}", before, K1=1, K1_dense_sm90=1)
        f32 = [x.float() for x in (q, k, v, do)]
        o_want, lse_want = flash_fwd.fwd_reference(*f32[:3], **kw)
        live = lse_want > math.log(2.0) * DEFAULT_MASK_VALUE * 0.5
        ok_o, msg_o = check_close(o, o_want, o_tol, "O")
        ok_l, msg_l = check_close(lse[live], lse_want[live], lse_tol, "LSE")
        err1 = (o.float() - o_want).abs().max().item()
        delta = (f32[3] * o_want.float()).sum(-1)
        args = (q, k, v, do, lse_want, delta)
        before = _launches()
        got = flash_bwd.split_bwd(*args, **kw)
        torch.cuda.synchronize()
        _routed(f"K5 + K6's split route at {name}", before, split_bwd=1)
        ok_b, why_b, err_b, _ = grad_gate(got, flash_bwd.split_bwd_reference(
            *f32, lse_want, delta, **kw), g_tol, names=("dq", "dk", "dv"))
        dead = ~live
        dead_zero = bool((o[dead] == 0).all() and (got[0][dead] == 0).all())
        log("seg", f"{name} B{B} Hq{Hq} Hkv{Hkv} Nq{Nq} Nk{Nk} D{D} "
                   f"{'causal' if causal else 'non-causal'} {kind} ids: K1 O max_abs_err "
                   f"{err1:.3e} (budget {O_TOL_NAME}), LSE live rows max_abs_err "
                   f"{(lse[live] - lse_want[live]).abs().max().item():.3e} (budget {LSE_ATOL}); "
                   f"K5 + K6 split route dQ/dK/dV {err_b:.3e} (budget BWD_TOL[bf16] atol "
                   f"{g_tol.atol} rtol {g_tol.rtol}); dead rows {int(dead.sum())}, their O "
                   f"and dQ exactly 0: {dead_zero}")
        if not (ok_o and ok_l):
            fail(f"K1 with segments disagrees with fwd_reference at {name}: {msg_o}; {msg_l}")
        if not ok_b:
            fail(f"K5 + K6's split route disagrees with split_bwd_reference at {name}: {why_b}")
        if not dead_zero:
            fail(f"dead rows at {name}: O or dQ not exactly 0")
        if kind == "dead" and not dead.any():
            fail("the dead-row case has no dead row")
        if name == "packed":
            res = {"k1": {"max_abs_err": err1}, "split": {"max_abs_err": err_b}}
            packed = (q, k, v, do, lse_want, delta, kw)
        del got, f32

    q, k, v, do, lse_want, delta, kw = packed
    args = (q, k, v, do, lse_want, delta)
    B, Hq, Hkv, N, _, D = SEG_CASES[0][1:7]
    timed = {"k1": (lambda: flash_fwd.fwd(q, k, v, **kw),
                    lambda: flash_fwd.fwd_reference(q, k, v, **kw)),
             "split": (lambda: flash_bwd.split_bwd(*args, **kw),
                       lambda: flash_bwd.split_bwd_reference(*args, **kw))}
    for key, (kernel, plain) in timed.items():
        res[key]["ms"] = cuda_ms(kernel)
        res[key]["plain_ms"] = cuda_ms(plain, reps=3)
    mask = dict(kv_valid_len=N, causal=True, segment_ids=kw["segment_ids"])
    ids = tensor_bytes(*kw["segment_ids"])
    stats = 4 * B * Hq * N  # one f32 per row: LSE or Delta
    res["k1"].update(bound(tensor_bytes(q, k, v, q) + stats + ids,
                           pair_flops(q, k, matmuls=2, **mask)))
    # In: q, k, v, dO, LSE, Delta, the ids; out: dQ, dK, dV as the function
    # returns them (bf16; dK / dV at Hkv heads).
    res["split"].update(bound(tensor_bytes(q, k, v, do) + 2 * stats + ids + tensor_bytes(q, k, v),
                              pair_flops(q, k, matmuls=5, **mask)))
    docs = band_mod(None, kw["segment_ids"][0])
    res["k1"].update(library_ms=flex_ms(q, k, v, scale=kw["scale"], mask_mod=docs),
                     library_call="flex_attention (torch.compile) with the causal document mask")
    res["split"].update(
        library_ms=flex_ms(q, k, v, scale=kw["scale"], do=do, mask_mod=docs),
        library_call="the backward of flex_attention (torch.compile) with the causal document "
                     "mask (dQ, dK and dV in one call)")
    causal_ms = cuda_ms(lambda: flash_fwd.fwd(q, k, v, scale=kw["scale"], causal=True))
    k3_ms = cuda_ms(lambda: flash_bwd_fused.bwd(*args, scale=kw["scale"], causal=True))
    # The dense route's call is the segment inputs' few small launches
    # (flash_fwd.sm90_segments: one aminmax per side) and then the kernel; each
    # alone, the kernel on inputs made once.
    from flashattn_tpu_torch.utils import native

    seg = flash_fwd.sm90_segments(kw["segment_ids"], N, N)
    o_k, lse_k = torch.empty_like(q), torch.empty((B, Hq, N), dtype=torch.float32, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    alone_ms = cuda_ms(lambda: flash_fwd._launch_dense_sm90(
        native.kernels(), q, k, v, o_k, lse_k, seg, scale=kw["scale"], kv_valid_len=N, causal=True,
        window=None, softcap=None, stream=stream))
    seg_ms = cuda_ms(lambda: flash_fwd.sm90_segments(kw["segment_ids"], N, N))
    tf = pair_flops(q, k, matmuls=5, **mask) / 1e9
    log("seg", f"packed shape B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal, 8 documents per row, bf16: "
               f"K1 with segments {res['k1']['ms']:.4f} ms (plain {res['k1']['plain_ms']:.4f}), "
               f"K5 + K6 split route {res['split']['ms']:.4f} ms ({tf / res['split']['ms']:.1f} "
               f"TFLOP/s; plain {res['split']['plain_ms']:.4f}, bound "
               f"{res['split']['bound_ms']:.4f} {res['split']['bound_by']}); flex_attention "
               f"{ms_text(res['k1']['library_ms'])} ms, its backward "
               f"{ms_text(res['split']['library_ms'])} ms (median CUDA-event time)")
    log("seg", f"not gated: K1 causal without segments at the same shape {causal_ms:.4f} ms; "
               f"K1 with segments / K1 causal = {res['k1']['ms'] / causal_ms:.3f}; of the K1 call, "
               f"the kernel alone {alone_ms:.4f} ms, the segment inputs alone (sm90_segments) "
               f"{seg_ms:.4f} ms; K3 causal without segments {k3_ms:.4f} ms, the split route / "
               f"K3 = {res['split']['ms'] / k3_ms:.3f}")
    _tma_wgmma_sass("seg", {f"K5 + K6 split sm90{' segments' if sg else ''}"
                           f"{' softcap' if cp else ''} bwd_split_sm90_kernel<{d}, {sg}, {cp}>"
                           for d in (64, 128) for sg, cp in ((1, 0), (0, 1), (1, 1))})
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
            _reset_launches()
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
            launches = _launches()
        s_req = statistics.mean(secs)
        log("slice", f"{arm}: {REQUESTS} requests x {STEPS} Euler steps, "
                     f"{s_req:.4f} s/request ({', '.join(f'{s:.4f}' for s in secs)}), "
                     f"{STEPS / s_req:.2f} it/s, latents finite")
    log("slice", f"launches during the fused requests: {launches} (expected K1 = K1 dense sm90 "
                 f"= {per_forward} per forward from _exact_is_faster x {STEPS} steps x "
                 f"{REQUESTS} requests = {expected}, no other)")
    if launches != _expect(K1=expected, K1_dense_sm90=expected):
        fail(f"the U-Net launched {launches} on the main path, expected K1 = K1 dense sm90 = "
             f"{expected} and no other")
    return launches["K1 dense sm90"]


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
              steps: int = LM_STEPS, warmup: int = LM_WARMUP, profile: dict | None = None
              ) -> float:
    """``steps`` AdamW steps from the seed-0 weights; logs ms/step (median
    after ``warmup`` warm-up steps), tokens/s, peak GB and the losses, fails
    unless the losses are finite and falling, and returns s/step. Given
    ``profile`` (a dict), one more step runs under torch.profiler and
    ``profile`` gains its wall ms, the device ms of every kernel, the device
    ms of each kernel by name, and the card's clocks, power and temperature
    read just after it."""
    from flashattn_tpu_torch.models.transformer import (
        adamw_init, adamw_update, init_transformer, lm_loss)

    model = init_transformer(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []

    def step():
        model.zero_grad(set_to_none=True)
        loss = lm_loss(model, tokens, cfg, attn_impl=arm, segment_ids=segment_ids)
        loss.backward()
        adamw_update({n: p.grad for n, p in params.items()}, opt, params)
        torch.cuda.synchronize()
        return loss

    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    if profile is not None:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        t0 = time.perf_counter()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
        profile["wall_ms"] = (time.perf_counter() - t0) * 1e3
        profile["card"] = _card_state()
        by_name = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
            if t > 0:
                by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3
        profile["kernels_ms"] = by_name
        profile["device_ms"] = sum(by_name.values())
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
    from flashattn_tpu_torch.parallel import ring_kernel

    flash_fwd.fwd.launches = flash_bwd_fused.bwd.launches = 0
    flash_fwd.fwd.launches_bias = flash_fwd.fwd.launches_int8 = flash_fwd.fwd.launches_fp8 = 0
    flash_fwd.fwd.launches_bias_sm90 = flash_fwd.fwd.launches_dense_sm90 = 0
    flash_fwd.fwd.launches_dense_d256 = flash_fwd.fwd.launches_bias_d256 = 0
    flash_fwd.fwd.launches_quant_sm90 = flash_fwd.fwd.launches_quant_f32 = 0
    flash_fwd.fwd.launches_decode_f32 = 0
    flash_bwd.bias_bwd.launches_d256 = 0
    flash_bwd_fused.bwd.launches_sm90 = flash_bwd_fused.bwd.launches_d256 = 0
    flash_bwd.split_bwd.launches_d256 = 0
    flash_fwd.fwd.launches_window = flash_fwd.fwd.launches_softcap = 0
    flash_fwd.fwd.launches_decode = flash_fwd.fwd.launches_merge = 0
    flash_bwd.bias_bwd.launches = flash_bwd.bias_bwd.launches_dbias = 0
    flash_bwd.split_bwd.launches = 0
    flash_fwd.fwd.launches_f32 = flash_bwd._f32_bwd_launch.launches = 0
    flash_fwd.fwd.launches_f32_bias = flash_bwd.bias_bwd.launches_f32 = 0
    flash_fwd.fwd.launches_f32_d256 = flash_bwd._f32_bwd_launch.launches_d256 = 0
    flash_fwd.fwd.launches_split = flash_bwd._f32_bwd_launch.launches_split = 0
    gemm.matmul.launches = roofline.roofline_call.launches = 0
    gemm.matmul.launches_f32 = gemm.matmul.launches_split = 0
    roofline.roofline_call.launches_f32 = 0
    for step in (ring_kernel.ring_fwd_step, ring_kernel.ring_bwd_step):
        step.launches = step.launches_f32 = step.launches_d256 = step.launches_split = 0


def _launches() -> dict:
    """Every kernel's launch count; "K1" counts all K1 launches, "K1 bias",
    "K1 int8", "K1 fp8", "K1 window" and "K1 softcap" those of its variants
    (a launch with a window and a softcap counts in both), "K1 bias sm90"
    those of K1's bias route (also counted in "K1 bias"), "K1 bias d256"
    those of its D 256 form (bf16 above D 128), "K1 dense sm90"
    those of K1's dense route (a window's also in "K1 window", a cap's in
    "K1 softcap"), "K1 dense d256" those of its D 256 form (bf16 above D
    128), "K1 quant sm90" those of K1's quantized route (int8 / fp8 K/V not
    decode-shaped, also in "K1 int8" / "K1 fp8"); "K3" all K3 launches, "K3 sm90" those of its Hopper
    kernel, "K3 d256" those of its D 256 form (bf16 above D 128); "bias
    bwd" the launches of K5 + K6's bias route (one kernel for both, with a
    bias and, if any, the softcap), "bias bwd dbias" those that wrote dbias,
    "bias bwd d256" those of its D 256 form (bf16 above D 128);
    "split bwd" those of K5 + K6 without a bias (one kernel for both, with
    segment ids and / or the softcap), "split bwd d256" those of its D 256
    form; "K1 f32" the launches of K1's f32 kernel (also counted in "K1",
    and in "K1 window" / "K1 softcap"), "K1 f32 bias" those of its BIAS
    family (also in "K1 f32" and "K1 bias"), "K1 f32 d256" those of its D
    256 form (f32 above D 128, with or without a bias), "bwd f32" those of
    the f32 backward body, which K3's f32 calls (also counted in "K3"), the
    split route's (in "split bwd") and the bias route's (in "bias bwd" and
    "bias bwd f32", with dbias also in "bias bwd dbias") launch, "bwd f32
    d256" those of its D 256 form (f32 above D 128, whichever route); "split bf16x3"
    those of the f32 routes' operand split (one
    before each K1 f32 launch, of q, k and v, and one before each bwd f32
    launch, of q, k, v and dO, both from the f32 C entries, and one before
    each K7 / K8 f32 launch: "K7 f32" / "K8 f32" those of the ring kernels'
    f32 forms, "K7 d256" / "K8 d256" those of their D 256 forms, all also in
    "K7" / "K8"; and one before each K9 f32 launch, of a and b); "K1
    decode f32" the launches of the decode kernel's f32-q form (an f32 q
    over int8 / fp8 K/V, also in "K1" and "K1 int8" / "K1 fp8"; its merges
    in "K1 merge"), "K1 quant f32" those of the quantized route's f32-q
    form (likewise, each after one split of q), "K9 f32" / "K10 f32" those
    of the probes' f32 forms (also in "K9" / "K10"). K5 and K6 have
    no kernel of their own: every CUDA backward that is not K3's takes one
    of the routes."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd, gemm, roofline
    from flashattn_tpu_torch.parallel import ring_kernel

    return {"K1": flash_fwd.fwd.launches, "K1 bias": flash_fwd.fwd.launches_bias,
            "K1 bias sm90": flash_fwd.fwd.launches_bias_sm90,
            "K1 bias d256": flash_fwd.fwd.launches_bias_d256,
            "K1 dense sm90": flash_fwd.fwd.launches_dense_sm90,
            "K1 dense d256": flash_fwd.fwd.launches_dense_d256,
            "K1 quant sm90": flash_fwd.fwd.launches_quant_sm90,
            "K1 quant f32": flash_fwd.fwd.launches_quant_f32,
            "K1 decode f32": flash_fwd.fwd.launches_decode_f32,
            "K1 int8": flash_fwd.fwd.launches_int8, "K1 fp8": flash_fwd.fwd.launches_fp8,
            "K1 window": flash_fwd.fwd.launches_window,
            "K1 softcap": flash_fwd.fwd.launches_softcap,
            "K1 decode": flash_fwd.fwd.launches_decode, "K1 merge": flash_fwd.fwd.launches_merge,
            "K3": flash_bwd_fused.bwd.launches, "K3 sm90": flash_bwd_fused.bwd.launches_sm90,
            "K3 d256": flash_bwd_fused.bwd.launches_d256,
            "bias bwd": flash_bwd.bias_bwd.launches,
            "bias bwd dbias": flash_bwd.bias_bwd.launches_dbias,
            "bias bwd d256": flash_bwd.bias_bwd.launches_d256,
            "split bwd": flash_bwd.split_bwd.launches,
            "split bwd d256": flash_bwd.split_bwd.launches_d256,
            "K1 f32": flash_fwd.fwd.launches_f32, "bwd f32": flash_bwd._f32_bwd_launch.launches,
            "K1 f32 bias": flash_fwd.fwd.launches_f32_bias,
            "K1 f32 d256": flash_fwd.fwd.launches_f32_d256,
            "bias bwd f32": flash_bwd.bias_bwd.launches_f32,
            "bwd f32 d256": flash_bwd._f32_bwd_launch.launches_d256,
            "split bf16x3": (flash_fwd.fwd.launches_split
                             + flash_bwd._f32_bwd_launch.launches_split
                             + ring_kernel.ring_fwd_step.launches_split
                             + ring_kernel.ring_bwd_step.launches_split
                             + gemm.matmul.launches_split),
            "K7": ring_kernel.ring_fwd_step.launches, "K8": ring_kernel.ring_bwd_step.launches,
            "K7 f32": ring_kernel.ring_fwd_step.launches_f32,
            "K8 f32": ring_kernel.ring_bwd_step.launches_f32,
            "K7 d256": ring_kernel.ring_fwd_step.launches_d256,
            "K8 d256": ring_kernel.ring_bwd_step.launches_d256,
            "K9": gemm.matmul.launches, "K10": roofline.roofline_call.launches,
            "K9 f32": gemm.matmul.launches_f32, "K10 f32": roofline.roofline_call.launches_f32}


def _expect(**counts) -> dict:
    """A launch-count dict with every kernel not named at 0."""
    return {**dict.fromkeys(_launches(), 0), **{k.replace("_", " "): v for k, v in counts.items()}}


def _routed(tag: str, before: dict, **want) -> None:
    """Fail unless the launches since ``before`` (a _launches() dict) are
    exactly ``want`` (named as _expect's arguments) and no other: a kernel
    check's call went through the route it is meant to hold."""
    now = _launches()
    got = {n: now[n] - before[n] for n in now if now[n] != before[n]}
    if got != {k.replace("_", " "): v for k, v in want.items() if v}:
        fail(f"{tag} launched {got}, expected {want}")


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
    log("train", f"launches during the fused steps: {counts} (expected K1 = K1 dense sm90 = K3 "
                 f"= K3 sm90 = {cfg.n_layers} layers x {LM_STEPS} steps = {expected}, no other)")
    if counts != _expect(K1=expected, K1_dense_sm90=expected, K3=expected, K3_sm90=expected):
        fail(f"LM steps launched {counts}, expected K1 = K1 dense sm90 = K3 = K3 sm90 = "
             f"{expected} and no other")
    return counts["K1 dense sm90"], counts["K3 sm90"]


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
    log("packed", f"launches during the packed fused steps: {counts} (expected K1 = K1 dense "
                  f"sm90 = split bwd = {cfg.n_layers} layers x {LM_STEPS} steps = {expected}, "
                  "no K5, K6 or other)")
    if counts != _expect(K1=expected, K1_dense_sm90=expected, split_bwd=expected):
        fail(f"packed LM steps launched {counts}, expected K1 = K1 dense sm90 = split bwd = "
             f"{expected} and no other")
    return counts


# bench_decode.py:124-138: decode attention, B8 H16 D128 against an 8192-slot
# cache; the Hkv < 16 cases run GQA-folded.
DECODE_B, DECODE_H, DECODE_NK, DECODE_D = 8, 16, 8192, 128
KV_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn}
# The decode kernel's variants: (K/V dtype, softcap).
DECODE_VARIANTS = {"bf16": (torch.bfloat16, None), "int8": (torch.int8, None),
                   "fp8": (torch.float8_e4m3fn, None), "softcap": (torch.bfloat16, SOFTCAP)}
# (name, B, Hq, Hkv, Nq, Nk, D, bias, causal): the call decode_step makes at
# bench_decode's cache length 8192 held at half (its 4097 live slots, no bias),
# timed for the kernel rows; bench_decode's shapes at Hkv 16, 8, 4, 2 over the
# whole cache with the JAX step's cache-slot bias (half the slots live; Hkv 8
# timed beside the earlier design's times), Nq 16 without bias, 32 folded rows
# (two Q tiles), Nk 8191, batch row 0 masked entirely, the fewest splits (1)
# and the most (B1 Hkv1: 4 CTAs per SM), D 64; then a causal [B, H, Nq, Nk]
# bias, which the dense K1 takes.
DECODE_LIVE = DECODE_NK // 2 + 1
DECODE_CASES = [("live", DECODE_B, DECODE_H, 8, 1, DECODE_LIVE, DECODE_D, None, False)]
DECODE_CASES += [(f"Hkv{hkv}", DECODE_B, DECODE_H, hkv, 1, DECODE_NK, DECODE_D, "slots", False)
                 for hkv in (16, 8, 4, 2)]
DECODE_CASES += [("Nq16", DECODE_B, DECODE_H, DECODE_H, 16, DECODE_NK, DECODE_D, None, False),
                 ("rows32", DECODE_B, DECODE_H, 8, 16, DECODE_NK, DECODE_D, "slots", False),
                 ("Nk8191", DECODE_B, DECODE_H, 8, 1, 8191, DECODE_D, "slots", False),
                 ("dead row", DECODE_B, DECODE_H, 8, 1, DECODE_NK, DECODE_D, "dead", False),
                 ("1 split", DECODE_B, DECODE_H, 8, 1, 200, DECODE_D, "slots", False),
                 ("most splits", 1, 8, 1, 1, 528 * 256, DECODE_D, "slots", False),
                 ("D64", 2, 8, 2, 1, 1000, 64, "slots", False),
                 ("dense causal", 2, 4, 4, 1000, 1100, 64, "random", True)]
# Beside FWD_TOL[bf16] per element, O's relative L2 error against the plain
# version: at these shapes |O| is ~0.03 (a row spreads over thousands of
# keys), so FWD_TOL's atol 2e-2 alone would pass a kernel that dropped a
# split's accumulator; bf16 rounding of P and O gives ~1e-3.
DECODE_REL_L2 = 1e-2


def _decode_slot_bias(nk: int, live: int) -> torch.Tensor:
    """The JAX decode_step's cache-slot mask: ``[1, 1, 1, nk]`` f32, -1e9
    past ``live``."""
    slot = torch.arange(nk, device=DEVICE)
    return torch.where(slot < live, 0.0, -1e9).to(torch.float32)[None, None, None]


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _decode_merges(batch: int, hkv: int, live: int) -> int:
    """Merge launches of one decode-kernel call over ``live`` keys: 1 when it
    has more than one split."""
    from flashattn_tpu_torch.ops import flash_fwd

    return int(_decode_splits(batch, hkv, live) > 1)


def _decode_splits(batch: int, hkv: int, live: int) -> int:
    """The decode kernel's split count on this card (its SM count)."""
    from flashattn_tpu_torch.ops import flash_fwd

    return flash_fwd.decode_splits(batch, hkv, live, _sms())[0]


def phase_decode_check() -> dict:
    """K1's decode route -- the split-KV decode kernel on bf16 K/V, with a
    softcap, and on int8 / fp8 K/V, each with and without a bias -- at
    DECODE_CASES. Each case goes through the path (flash_attention /
    flash_attention_quantized) against fwd_reference on the dequantized
    cache (O within FWD_TOL[bf16] and DECODE_REL_L2), with exactly one K1
    launch, on the decode kernel where decode_route takes the call (and its
    merge when it has more than one split) and on the dense K1 otherwise;
    then the kernel on the folded launch the path makes against
    decode_reference with the kernel's splits (O within FWD_TOL[bf16] and
    DECODE_REL_L2, LSE within LSE_ATOL; a masked batch row exactly O = 0 and
    LSE = ln2 x mask). Times each variant beside its plain version, with the
    KV read rate 2·B·Hkv·Nk·D·bytes / t of bench_decode.py:94: on the live
    case (decode_step's call; returned under the variant's name) and on the
    Hkv 8 case (the whole cache with the slot bias; under "<variant> bias"),
    beside SDPA (on int8 / fp8, on the dequantized bf16 cache, the
    dequantization not included)."""
    from flashattn_tpu_torch.ops import flash_fwd, quant
    from flashattn_tpu_torch.ops.flash import flash_attention
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import FWD_TOL, Tolerance, check_close, make_qkv

    tol, lse_tol = FWD_TOL[torch.bfloat16], Tolerance(LSE_ATOL, 0.0)
    res = {}
    for i, (case, b, hq, hkv, nq, nk, d, bias_kind, causal) in enumerate(DECODE_CASES):
        q, k, v = make_qkv(900 + i, b, hq, nq, d, Nk=nk, Hkv=hkv, dtype=torch.bfloat16,
                           device=DEVICE)
        bias = None
        if bias_kind in ("slots", "dead"):
            bias = _decode_slot_bias(nk, nk // 2)
        if bias_kind == "dead":  # batch row 0: every slot at the mask value
            bias = bias.expand(b, 1, 1, nk).clone()
            bias[0] = DEFAULT_MASK_VALUE
        elif bias_kind == "random":
            gen = torch.Generator(device=DEVICE).manual_seed(950 + i)
            bias = torch.randn((b, hq, nq, nk), generator=gen, device=DEVICE)
        rep = hq // hkv
        folded = rep > 1 and not causal and nq * rep <= 32
        # The launch the path makes: the folded query for tiny-Nq GQA.
        qk = q.reshape(b, hkv, rep * nq, d) if folded else q
        bias_k = bias.repeat(1, 1, rep, 1) if bias is not None and folded and bias.shape[2] > 1 \
            else bias
        route = flash_fwd.decode_route(rows=qk.shape[1] // hkv * qk.shape[2], causal=causal,
                                       segment_ids=None, window=None, head_dim=d)
        for name, (dtype, cap) in DECODE_VARIANTS.items():
            if cap is not None and bias_kind == "random":
                continue  # the dense K1's softcap is checked by phase_window_check
            kw = dict(scale=d ** -0.5, causal=causal, bias=bias, softcap=cap)
            before = (flash_fwd.fwd.launches, flash_fwd.fwd.launches_decode,
                      flash_fwd.fwd.launches_merge)
            if dtype == torch.bfloat16:
                o = flash_attention(q, k, v, bias=bias, causal=causal, logit_softcap=cap)
                kk, vv, scales = k, v, {}
            else:
                qkv = quant.quantize_kv(k, v, dtype, allow_slow_fp8=True)
                o = quant.flash_attention_quantized(q, qkv, bias=bias, causal=causal)
                kk, vv = qkv.k_q, qkv.v_q
                scales = dict(k_scale=qkv.k_scale, v_scale=qkv.v_scale)
            torch.cuda.synchronize()
            launched = tuple(x - y for x, y in zip(
                (flash_fwd.fwd.launches, flash_fwd.fwd.launches_decode,
                 flash_fwd.fwd.launches_merge), before))
            want = (1, 1, _decode_merges(b, hkv, nk)) if route else (1, 0, 0)
            o_want, _ = flash_fwd.fwd_reference(q.float(), kk, vv, **kw, **scales)
            ok, msg = check_close(o, o_want, tol, "O")
            err, rel = (o.float() - o_want).abs().max().item(), _rel(o.float(), o_want)
            label = (f"{case} {name} B{b} Hq{hq} Hkv{hkv} Nq{nq} Nk{nk} D{d}"
                     f"{' causal' if causal else ''}"
                     f"{'' if bias_kind is None else f' bias {bias_kind}'}"
                     f"{' folded' if folded else ''}")
            kern = ("decode kernel" if route else "dense K1" if dtype == torch.bfloat16
                    else "quantized K1")
            line = (f"{label}: path O max_abs_err {err:.3e} (budget {O_TOL_NAME}), relative "
                    f"L2 {rel:.3e} (limit {DECODE_REL_L2}), max|O| "
                    f"{o_want.abs().max().item():.3e}; launches K1 / decode / merge {launched} "
                    f"(expected {want}, the {kern})")
            if launched != want:
                fail(f"{label} launched K1 / decode / merge {launched}, expected {want}")
            if not (ok and rel <= DECODE_REL_L2):
                fail(f"K1 ({label}) disagrees with fwd_reference: {msg}; relative L2 {rel:.3e}")
            kernel_kw = {**kw, "bias": bias_k}
            dref_kw = {x: y for x, y in kernel_kw.items() if x != "causal"}
            splits = _decode_splits(b, hkv, nk)
            if route:
                o_k, lse_k = flash_fwd.fwd(qk, kk, vv, **kernel_kw, **scales)
                torch.cuda.synchronize()
                o_r, lse_r = flash_fwd.decode_reference(qk.float(), kk, vv, **dref_kw, **scales,
                                                        splits=splits)
                ok_o, msg_o = check_close(o_k, o_r, tol, "O")
                k_rel = _rel(o_k.float(), o_r)
                # Dead rows' LSE, ln2 x mask, is f32's product in the kernel:
                # within an ulp of the reference's, not within LSE_ATOL.
                live = lse_r > 0.5 * math.log(2.0) * DEFAULT_MASK_VALUE
                ok_l, msg_l = check_close(lse_k[live], lse_r[live], lse_tol, "LSE")
                ok_l = ok_l and torch.allclose(lse_k[~live], lse_r[~live], rtol=1e-6, atol=0.0)
                k_err = (o_k.float() - o_r).abs().max().item()
                lse_err = (lse_k[live] - lse_r[live]).abs().max().item() if live.any() else 0.0
                line += (f"; kernel vs decode_reference ({splits} splits): O max_abs_err "
                         f"{k_err:.3e}, relative L2 {k_rel:.3e} (limit {DECODE_REL_L2}), LSE "
                         f"max_abs_err on live rows {lse_err:.3e} (budget {LSE_ATOL})")
                if not (ok_o and ok_l and k_rel <= DECODE_REL_L2):
                    fail(f"the decode kernel ({label}) disagrees with decode_reference: "
                         f"{msg_o}; {msg_l}; O relative L2 {k_rel:.3e}")
                if bias_kind == "dead":
                    dead_o = o_k[0].float().abs().max().item()
                    dead_lse = torch.allclose(
                        lse_k[0], torch.full_like(lse_k[0], math.log(2.0) * DEFAULT_MASK_VALUE),
                        rtol=1e-6, atol=0.0)
                    line += f"; masked batch row: max|O| {dead_o}, LSE ln2 x mask {dead_lse}"
                    if dead_o != 0.0 or not dead_lse or o[0].float().abs().max().item() != 0.0:
                        fail(f"{label}: the masked batch row is not exactly O = 0, "
                             f"LSE = ln2 x mask")
            if case in ("live", "Hkv8"):  # the LM's decode attention
                key = name if case == "live" else f"{name} bias"
                ms = cuda_ms(lambda: flash_fwd.fwd(qk, kk, vv, **kernel_kw, **scales))
                plain_ms = cuda_ms(lambda: flash_fwd.decode_reference(
                    qk, kk, vv, **dref_kw, **scales, splits=splits), reps=3, trials=3)
                nbytes = 2 * b * hkv * nk * d * kk.element_size()
                line += (f"; decode kernel {ms * 1e3:.2f} us ({nbytes / ms / 1e6:.1f} GB/s KV "
                         f"read), plain {plain_ms * 1e3:.2f} us")
                res[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound(
                    tensor_bytes(q, kk, vv, bias, q, *scales.values()) + 4 * b * hq * nq,
                    4.0 * d * b * hq * nq * nk)}
                with_bias = "" if bias is None else " and bias"
                if dtype != torch.bfloat16:  # no PyTorch call takes 8-bit K/V and scales
                    kd, vd = (x.to(torch.bfloat16) for x in quant.dequantize_kv(qkv))
                    res[key]["library_ms"] = sdpa_ms(q, kd, vd, attn_mask=bias)
                    res[key]["library_call"] = (
                        f"scaled_dot_product_attention(attn_mask="
                        f"{'bias' if bias is not None else 'None'}, enable_gqa=True) on the "
                        "dequantized bf16 K/V, the dequantization not included")
                    del kd, vd
                elif cap is None:
                    res[key]["library_ms"] = sdpa_ms(q, k, v, attn_mask=bias)
                    res[key]["library_call"] = (f"scaled_dot_product_attention(attn_mask="
                                                f"{'bias' if bias is not None else 'None'}, "
                                                "enable_gqa=True)")
                else:
                    res[key]["library_ms"] = flex_ms(q, k, v, scale=kw["scale"],
                                                     score_mod=softcap_mod(cap, bias))
                    res[key]["library_call"] = ("flex_attention (torch.compile) with the "
                                                f"softcap{with_bias} score_mod")
                line += f", library {res[key]['library_ms']}"
            log("decode", line)
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
# The launch counters of each cache dtype's decode variant beside K1 decode
# (decode_step passes no bias: a bf16 cache counts in no variant counter).
DECODE_COUNTER = {"bf16": {}, "int8": {"K1_int8": 1}, "fp8": {"K1_fp8": 1}}


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


def _dead_lse() -> float:
    """A dead row's LSE as the kernels write it: LN2 * MASK_VALUE, two f32
    constants multiplied in f32 (csrc/common.cuh), one ulp from the plain
    versions' f64 product."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32)
    return (f32(0.6931471805599453) * (f32(-0.7) * f32(3.4028234663852886e38))).item()


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
    tokens), with exactly 16 K1 launches per step, all on the decode kernel
    in the dtype's variant (no dense K1), its merge kernel exactly where the
    live slots make more than one split, and no other kernel; then ms/token
    and tokens/s at cache lengths 1024, 4096 and 8192 with the length held
    at half (bench_decode.py:46-55), batch 8, and the peak device memory,
    the launches checked the same way. Returns the launch counts per dtype,
    summed over the requests and the timed steps."""
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
        n = cfg.n_layers * steps
        merges = cfg.n_layers * sum(_decode_merges(DECODE_REQUESTS, cfg.n_kv_heads, t + 1)
                                    for t in range(steps))
        want = _expect(K1=n, K1_decode=n, K1_merge=merges,
                       **{c: n for c in DECODE_COUNTER[name]})
        log("decode", f"{name} cache: {DECODE_REQUESTS} requests at batch {DECODE_REQUESTS}, "
                      f"{PROMPT_LEN}-token prompt + {GEN_LEN} greedy tokens = {steps} steps in "
                      f"{secs:.3f} s ({secs / steps * 1e3:.2f} ms/step, "
                      f"{DECODE_REQUESTS * steps / secs:.0f} tokens/s); first request's tokens "
                      f"{out[0, :8].tolist()}...; launches {counts[name]} (expected "
                      f"{cfg.n_layers} x {steps} = {n} K1, all on the decode kernel "
                      f"without a bias{''.join(', ' + c.replace('_', ' ') for c in DECODE_COUNTER[name])}"
                      f", {merges} merges)")
        if counts[name] != want:
            fail(f"{name} decode launched {counts[name]}, expected {want}")
        del cache
        torch.cuda.empty_cache()

    for cache_len in DECODE_CACHE_LENS:
        for name, dt in KV_DTYPES.items():
            _reset_launches()
            _decode_ms(model, cfg, cache_len, None if dt == torch.bfloat16 else dt,
                       phase="decode", label=f"{name} cache")
            timed = _launches()
            n = cfg.n_layers * (DECODE_WARMUP + DECODE_STEPS)
            want = _expect(K1=n, K1_decode=n, **{c: n for c in DECODE_COUNTER[name]},
                           K1_merge=n * _decode_merges(DECODE_B, cfg.n_kv_heads,
                                                       cache_len // 2 + 1))
            if timed != want:
                fail(f"{name} decode at cache length {cache_len} launched {timed}, expected "
                     f"{want}")
            counts[name] = {x: counts[name][x] + timed[x] for x in timed}
    log("decode", f"launches over the requests and the timed steps: {counts} (16 decode "
                  "kernels per step, no dense K1)")
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


# The f32 LM served on the card (phase_decode_f32): DECODE_WIDTH in f32 from
# an f32, an int8 and an fp8 cache, through init_kv_cache and decode_step.
# The gate: the f32-cache decode logits against the teacher-forced f32
# forward within the f32 LM's limit (PERF.md §2), the 8-bit caches' against
# the f32 cache's by QUANT_RULE; then DECODE_F32_ROUNDS rounds of
# DECODE_REQUESTS requests per cache dtype (PROMPT_LEN prompt tokens through
# decode_step, DECODE_F32_GEN greedy tokens).
DECODE_F32_REL_L2 = 1e-3
DECODE_F32_ROUNDS, DECODE_F32_GEN = 2, 32
F32_CACHES = {"f32": None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}
# The decode kernel's f32-q form alone (_decode_f32_check): (name, B, Hq, Hkv,
# Nq, Nk, D, bias kind) -- decode_step's call at cache 8192 held at half (its
# 4097 live slots, folded), the whole cache with the JAX step's slot bias,
# one split, D 64, a batch row every slot of which is masked.
DECODE_F32_CASES = [("live", DECODE_B, DECODE_H, 8, 1, DECODE_LIVE, DECODE_D, None),
                    ("slot bias", DECODE_B, DECODE_H, 8, 1, DECODE_NK, DECODE_D, "slots"),
                    ("1 split", 2, DECODE_H, 8, 1, 200, DECODE_D, None),
                    ("D64", 2, 8, 2, 1, 1000, 64, "slots"),
                    ("dead row", 2, DECODE_H, 8, 1, 1000, DECODE_D, "dead")]


def _f32_decode_expect(name: str, batch: int, lives) -> dict:
    """The launches of the f32 LM's decode_step over steps whose live slots
    are ``lives``: per layer and step one K1 launch -- on an f32 cache K1's
    f32 route, after its split of q, k and v; on an 8-bit cache the decode
    kernel's f32-q form (counted with the dtype), its merge where the live
    slots make more than one split, and no split."""
    layers, hkv = DECODE_WIDTH["n_layers"], DECODE_WIDTH["n_kv_heads"]
    n = layers * len(lives)
    if name == "f32":
        return _expect(K1=n, K1_f32=n, split_bf16x3=n)
    return _expect(K1=n, K1_decode_f32=n, **{f"K1_{name}": n},
                   K1_merge=layers * sum(_decode_merges(batch, hkv, live) for live in lives))


def _decode_f32_check() -> dict:
    """The decode kernel's f32-q form (csrc/flash_decode_quant_f32.cu) on int8
    and fp8 K/V at DECODE_F32_CASES, q in f32: through the path
    (flash_attention_quantized) against fwd_reference on the same 8-bit K/V
    and scales, with exactly one K1 launch on the f32-q form and its merge
    where the splits make one; the kernel on the folded launch against
    decode_reference with the kernel's splits (O within FWD_TOL[f32], LSE
    within F32_LSE_ATOL on live rows; a masked batch row exactly O = 0, LSE =
    ln2 x mask). Timed at decode_step's call (the "live" case) beside its
    plain version, its bound (bytes: q, the 8-bit K/V and scales read once,
    O and the LSE written once) and SDPA f32 on the dequantized f32 K/V (TF32
    off; the dequantization not included). Returns the rows by K/V dtype."""
    from flashattn_tpu_torch.ops import flash_fwd, quant
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import FWD_TOL, Tolerance, check_close, make_qkv

    _f32_tf32_off()
    tol, lse_tol = FWD_TOL[torch.float32], Tolerance(F32_LSE_ATOL, 0.0)
    res = {}
    for i, (case, b, hq, hkv, nq, nk, d, bias_kind) in enumerate(DECODE_F32_CASES):
        q, k, v = make_qkv(2900 + i, b, hq, nq, d, Nk=nk, Hkv=hkv, device=DEVICE)  # f32
        bias = None if bias_kind is None else _decode_slot_bias(nk, nk // 2)
        if bias_kind == "dead":  # batch row 0: every slot at the mask value
            bias = bias.expand(b, 1, 1, nk).clone()
            bias[0] = DEFAULT_MASK_VALUE
        rep = hq // hkv
        qk = q.reshape(b, hkv, rep * nq, d)  # the folded launch the path makes
        splits = _decode_splits(b, hkv, nk)
        for name, dt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
            qkv = quant.quantize_kv(k, v, dt, allow_slow_fp8=True)
            scales = dict(k_scale=qkv.k_scale, v_scale=qkv.v_scale)
            before = _launches()
            o = quant.flash_attention_quantized(q, qkv, bias=bias)
            torch.cuda.synchronize()
            label = (f"f32 q, {name} K/V, {case}: B{b} Hq{hq} Hkv{hkv} Nq{nq} Nk{nk} D{d}"
                     f"{'' if bias_kind is None else f' bias {bias_kind}'}, folded")
            _routed(label, before, K1=1, K1_decode_f32=1, **{f"K1_{name}": 1},
                    K1_merge=int(splits > 1))
            o_want, _ = flash_fwd.fwd_reference(q, qkv.k_q, qkv.v_q, scale=d ** -0.5, bias=bias,
                                                **scales)
            ok, msg = check_close(o, o_want, tol, "O")
            err = (o - o_want).abs().max().item()
            if not ok or o.dtype != torch.float32:
                fail(f"the decode kernel's f32-q form ({label}) through the path disagrees with "
                     f"fwd_reference: {msg} (O {o.dtype})")
            kw = dict(scale=d ** -0.5, bias=bias, **scales)
            o_k, lse_k = flash_fwd.fwd(qk, qkv.k_q, qkv.v_q, **kw)
            torch.cuda.synchronize()
            o_r, lse_r = flash_fwd.decode_reference(qk, qkv.k_q, qkv.v_q, **kw, splits=splits)
            ok_o, msg_o = check_close(o_k, o_r, tol, "O")
            live = lse_r > 0.5 * math.log(2.0) * DEFAULT_MASK_VALUE
            ok_l, msg_l = check_close(lse_k[live], lse_r[live], lse_tol, "LSE")
            ok_l = ok_l and torch.allclose(lse_k[~live], lse_r[~live], rtol=1e-6, atol=0.0)
            k_err = (o_k - o_r).abs().max().item()
            lse_err = (lse_k[live] - lse_r[live]).abs().max().item()
            line = (f"{label}: path O max_abs_err {err:.3e} (budget FWD_TOL[f32]); kernel vs "
                    f"decode_reference ({splits} splits): O max_abs_err {k_err:.3e}, LSE "
                    f"max_abs_err on live rows {lse_err:.3e} (budget {F32_LSE_ATOL})")
            if not (ok_o and ok_l):
                fail(f"the decode kernel's f32-q form ({label}) disagrees with "
                     f"decode_reference: {msg_o}; {msg_l}")
            if bias_kind == "dead":
                dead_o = o_k[0].abs().max().item()
                line += f"; masked batch row: max|O| {dead_o}"
                if dead_o != 0.0 or o[0].abs().max().item() != 0.0 or (~live[0]).sum() == 0:
                    fail(f"{label}: the masked batch row is not exactly O = 0, LSE = ln2 x mask")
            if case == "live":  # decode_step's call
                call = lambda: flash_fwd.fwd(qk, qkv.k_q, qkv.v_q, **kw)  # noqa: E731
                kd, vd = quant.dequantize_kv(qkv, torch.float32)
                nbytes = tensor_bytes(q, qkv.k_q, qkv.v_q, *scales.values(), q) + 4 * b * hq * nq
                # Three bf16 products per f32 product (q's pieces on the exactly widened K/V).
                res[name] = {"max_abs_err": err, "ms": cuda_ms(call),
                             "kernel_ms": kernels_ms(call),
                             "plain_ms": cuda_ms(lambda: flash_fwd.decode_reference(
                                 qk, qkv.k_q, qkv.v_q, **kw, splits=splits), reps=3, trials=3),
                             **bound(nbytes, 3 * 4.0 * d * b * hq * nq * nk),
                             **_f32_library_ms(q, kd, vd, None, {})}
                res[name]["library_call"] = (f"{res[name]['library']} on the dequantized f32 "
                                             "K/V, the dequantization not included")
                r = res[name]
                line += (f"; {r['ms'] * 1e3:.2f} us (kernels alone {r['kernel_ms'] * 1e3:.2f}; "
                         f"{2 * b * hkv * nk * d / r['ms'] / 1e6:.1f} GB/s of K/V), plain "
                         f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
                         f"({r['bound_by']}), library {r['library_ms'] * 1e3:.2f} us "
                         f"({r['library_call']})")
                del kd, vd
            log("decode f32", line)
            del qkv
        del q, k, v, qk
        torch.cuda.empty_cache()
    return res


def phase_decode_f32() -> dict:
    """The f32 LM served at DECODE_WIDTH (820.6 M params, 3.3 GB in f32) from
    an f32, an int8 and an fp8 cache. The decode kernel's f32-q form alone
    first (_decode_f32_check). Then gates at batch 2 over the first
    DECODE_GATE_TOKENS tokens: the f32-cache decode logits against the
    teacher-forced f32 forward (K1's f32 route), relative L2 within
    DECODE_F32_REL_L2; the int8 and fp8 caches' against the f32 cache's by
    QUANT_RULE. Then DECODE_F32_ROUNDS rounds of DECODE_REQUESTS requests at
    batch DECODE_REQUESTS per cache dtype (a PROMPT_LEN-token prompt through
    decode_step, DECODE_F32_GEN greedy tokens) with exact launches
    (_f32_decode_expect: 16 K1 launches a step, on an 8-bit cache all of
    them the decode kernel's f32-q form with its merge where the splits make
    one, no split and no other K1 kernel; on an f32 cache K1's f32 route,
    whose C entry splits the live K/V on every call); then ms/token and
    tokens/s at cache lengths DECODE_CACHE_LENS held at half, batch
    DECODE_B, with the peak device memory and the launches checked the same
    way. Returns the kernel rows and the launch counts per cache dtype."""
    from flashattn_tpu_torch.models.transformer import (
        TransformerConfig, decode_step, init_kv_cache, init_transformer, transformer_forward)

    rows = _decode_f32_check()
    _f32_tf32_off()
    cfg = TransformerConfig(**DECODE_WIDTH, dtype=torch.float32)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = init_transformer(cfg, gen, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (2, DECODE_GATE_TOKENS), generator=gen,
                           device=DEVICE)
    with torch.no_grad():
        fwd = transformer_forward(model, tokens, cfg)
    dec = {name: _decode_logits(model, cfg, tokens, dt) for name, dt in F32_CACHES.items()}
    torch.cuda.synchronize()
    for name, x in dec.items():
        if x.shape != fwd.shape or not torch.isfinite(x).all():
            fail(f"f32 LM, {name} cache: decode logits of shape {tuple(x.shape)} or not finite")
    rel = _rel(dec["f32"], fwd)
    log("decode f32", f"f32 LM ({n_params / 1e6:.1f} M params, {cfg.n_layers} layers, d_model "
                      f"{cfg.d_model}, Hq{cfg.n_heads} Hkv{cfg.n_kv_heads} D{cfg.d_head}, f32), "
                      f"{list(tokens.shape)} tokens: f32-cache decode vs teacher-forced f32 "
                      f"forward relative L2 {rel:.3e} (limit {DECODE_F32_REL_L2})")
    if not rel <= DECODE_F32_REL_L2:
        fail(f"f32 decode gate: decode vs forward relative L2 {rel:.3e} > {DECODE_F32_REL_L2}")
    scale = max(dec["f32"].abs().max().item(), 1.0)
    for name in ("int8", "fp8"):
        d = (dec[name] - dec["f32"]).abs().max().item()
        limit = QUANT_RULE[name] * scale
        log("decode f32", f"f32 LM, {name} cache vs f32 cache: max|dlogits| {d:.4f} (limit "
                          f"{QUANT_RULE[name]} x {scale:.4f} = {limit:.4f}), relative L2 "
                          f"{_rel(dec[name], dec['f32']):.3e}")
        if not d < limit:
            fail(f"f32 LM: the {name} cache's decode differs from the f32 cache's: {d} >= "
                 f"{limit}")
    del dec, fwd

    counts = {}
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    steps = PROMPT_LEN + DECODE_F32_GEN
    for name, dt in F32_CACHES.items():
        _reset_launches()
        t0 = time.perf_counter()
        for _ in range(DECODE_F32_ROUNDS):
            prompts = torch.randint(0, cfg.vocab_size, (DECODE_REQUESTS, PROMPT_LEN),
                                    generator=gen, device=DEVICE)
            cache = init_kv_cache(cfg, DECODE_REQUESTS, steps, dt, device=DEVICE)
            for t in range(PROMPT_LEN):
                logits, cache = decode_step(model, cache, prompts[:, t], cfg)
            out = []
            for _ in range(DECODE_F32_GEN):
                token = logits.argmax(-1)
                out.append(token)
                logits, cache = decode_step(model, cache, token, cfg)
            torch.cuda.synchronize()
            out = torch.stack(out, dim=1)
            if not torch.isfinite(logits).all() or not ((out >= 0) & (out < cfg.vocab_size)).all():
                fail(f"f32 LM, {name} cache: logits not finite or tokens out of range")
            del cache
        secs = time.perf_counter() - t0
        counts[name] = _launches()
        want = _f32_decode_expect(name, DECODE_REQUESTS,
                                  list(range(1, steps + 1)) * DECODE_F32_ROUNDS)
        n_steps = steps * DECODE_F32_ROUNDS
        log("decode f32", f"f32 LM, {name} cache: {DECODE_F32_ROUNDS} x {DECODE_REQUESTS} "
                          f"requests at batch {DECODE_REQUESTS}, {PROMPT_LEN}-token prompt + "
                          f"{DECODE_F32_GEN} greedy tokens = {n_steps} steps in {secs:.3f} s "
                          f"({secs / n_steps * 1e3:.2f} ms/step, "
                          f"{DECODE_REQUESTS * n_steps / secs:.0f} tokens/s); first request's "
                          f"tokens {out[0, :8].tolist()}...; launches "
                          f"{ {x: c for x, c in counts[name].items() if c} } (expected "
                          f"{ {x: c for x, c in want.items() if c} })")
        if counts[name] != want:
            fail(f"f32 LM, {name} cache: decode launched {counts[name]}, expected {want}")
        torch.cuda.empty_cache()

    ms = {}
    for cache_len in DECODE_CACHE_LENS:
        for name, dt in F32_CACHES.items():
            _reset_launches()
            ms[f"{name} {cache_len}"] = _decode_ms(model, cfg, cache_len, dt, phase="decode f32",
                                                   label=f"f32 LM, {name} cache")
            timed = _launches()
            want = _f32_decode_expect(name, DECODE_B,
                                      [cache_len // 2 + 1] * (DECODE_WARMUP + DECODE_STEPS))
            if timed != want:
                fail(f"f32 LM, {name} cache at cache length {cache_len}: launched {timed}, "
                     f"expected {want}")
            counts[name] = {x: counts[name][x] + timed[x] for x in timed}
    log("decode f32", "launches over the requests and the timed steps: "
                      + "; ".join(f"{n}: { {x: c for x, c in cs.items() if c} }"
                                  for n, cs in counts.items()))
    del model
    torch.cuda.empty_cache()
    return {"rows": rows, "counts": counts, "s_per_token": ms}


def band_ranges(n_outer: int, n_inner: int, outer: int, inner: int, lo, hi):
    """The inner rows a banded kernel visits for each ``outer``-row tile:
    ``(o0, begin, end)``, the ``inner``-aligned tiles from ``begin`` that meet
    the band [o0 - lo, o0 + outer - 1 + hi] (None: unbounded), up to ``end``
    -- the ranges that the forward (csrc/fwd_sm90_tile.cuh: Q tiles outer,
    KV tiles inner) and the KV-major backward
    (csrc/bwd_sm90_tile.cuh: KV tiles outer, with lo and hi swapped) compute,
    restated here only to print how many tile pairs
    they visit. Whether the kernels' own ranges hold the band is shown by
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
# The softcap at a head dim run in a wider box: (B, Hq, Hkv, N, D, cap), a cap
# small enough that the grown scores saturate its tanh.
CAP_D40_CASE = (2, 8, 4, 1300, 40, 5.0)
# Head dims above 128 in the forward at B1 Hq8 Hkv4 D160 (phase_window_check's
# _wide_fwd_check): without a bias K1's dense route's D 256 form (D 160 in
# its box), with a bias its bias route's D 256 form; each also through its
# backward's D 256 form in phase_wide_bwd_check (the split route's, the bias
# route's with dbias): (tag, Nq, Nk, causal,
# window, ids kind as _seg_case_ids, bias, softcap, has dead rows) -- the
# dead rows of a window past the keys, of a segment no key carries and of
# key padding; cap 5 saturates the grown scores' tanh.
WIDE_D = 160
WIDE_CASES = [("softcap", 1024, 1024, True, None, None, False, 5.0, False),
              ("softcap + window", 1300, 1024, False, (64, -1), None, False, 5.0, True),
              ("softcap + ids", 1024, 1024, False, None, "dead", False, 5.0, True),
              ("softcap + window + ids", 1024, 1024, True, (200, -1), "random", False, 5.0,
               False),
              ("bias", 1024, 1024, False, None, None, True, None, True),
              ("softcap + bias", 1024, 1024, False, None, None, True, 5.0, True)]
# The D 256 form alone, forward only: (tag, D, Hkv, Nq, Nk, causal, (q_offset,
# kv_offset), has dead rows) at B1 Hq8 -- a contiguous ring's neighbour chunk
# pair (q_offset = Nq: every pair live), a pair whose band misses the first
# 512 rows whole (dead rows), D 136 ragged with GQA 8/1, and one query row.
WIDE_FWD_CASES = [("ring chunk pair", 256, 4, 1024, 1024, True, (1024, 0), False),
                  ("band misses rows", 256, 4, 1024, 1024, True, (0, 512), True),
                  ("ragged GQA 8/1", 136, 1, 1300, 1000, True, (0, 0), False),
                  ("Nq 1", 256, 4, 1, 1000, False, (0, 0), False)]


# K1's dense D 256 form at its 80-key KV tile (csrc/fwd_sm90_tile.cuh BN),
# forward only, q and k at GROW: (tag, D, Hq, Hkv, Nq, Nk, causal, window,
# (q_offset, kv_offset), ids) -- KV lengths that 80 does not divide (the
# masked partial tile) with a ragged Q tail, a window's left edge and a q / kv
# offset inside a tile, documents that end inside tiles (tile_edge_ids), GQA
# 4/1 and D 136 / 200 / 256.
TILE_CASES = [("Nk 1000, ragged Q", 256, 8, 4, 1000, 1000, False, None, (0, 0), None),
              ("Nk 2049 causal", 256, 8, 4, 2049, 2049, True, None, (0, 0), None),
              ("window edge at 200", 256, 8, 4, 1024, 1024, True, (200, -1), (0, 0), None),
              ("q_off - kv_off 40", 200, 8, 4, 1024, 1024, True, None, (40, 0), None),
              ("documents ending inside tiles", 256, 8, 4, 1000, 1000, True, None, (0, 0),
               "tile edges"),
              ("GQA 4/1 ragged", 136, 4, 1, 1300, 1000, True, None, (0, 0), None)]
# The document boundaries of tile_edge_ids: none on a 64- or 80-key tile edge.
TILE_EDGE_BOUNDS = (100, 250, 333, 700, 950)
# K7's D 256 form on one chunk pair at the 80-key tile: (chunk, Hq, Hkv, D).
RING_TILE_PAIR = (512, 8, 4, 256)


def tile_edge_ids(B: int, N: int, device=DEVICE) -> torch.Tensor:
    """int32 [B, N] ids whose documents end at TILE_EDGE_BOUNDS (below N)."""
    bounds = torch.tensor(TILE_EDGE_BOUNDS, device=device)
    return torch.bucketize(torch.arange(N, device=device), bounds, right=True).to(
        torch.int32).expand(B, N).contiguous()


def kernel_band(causal: bool, window, q_off: int, kv_off: int) -> tuple:
    """(lo, hi) of the kernels' band, None where unbounded: common.cuh
    band_bounds on the window (left, right) -- row i sees column j iff i - lo
    <= j <= i + hi -- shifted by q_off - kv_off."""
    delta = q_off - kv_off
    wl, wr = window if window is not None else (-1, -1)
    lo = wl - delta if wl >= 0 else None
    hi = delta if causal else (wr + delta if wr >= 0 else None)
    return lo, hi


def tile_visits(case, kv_tile: int) -> int:
    """The (128-row Q tile, ``kv_tile``-key tile) pairs the dense forward
    visits on a TILE_CASES entry, ids aside (band_tiles on kernel_band)."""
    _, _, _, _, nq, nk, causal, window, (qo, ko), _ = case
    return band_tiles(nq, nk, 128, kv_tile, *kernel_band(causal, window, qo, ko))


def ring_step_flops(hq: int, chunk: int, d: int, *, diagonal: bool, matmuls: int = 2) -> int:
    """The FLOPs of one ring step's ``matmuls`` products on a chunk pair: the
    diagonal pair's causal lower triangle, or every pair off it."""
    pairs = hq * (chunk * (chunk + 1) // 2 if diagonal else chunk * chunk)
    return matmuls * 2 * d * pairs


def _grown(seed, B, Hq, Nq, D, Nk, Hkv):
    """q, k (scaled by GROW) and v, bf16 [B, H, N, D] views of [B, N, H, D]."""
    from flashattn_tpu_torch.utils.testing import make_qkv

    q, k, v = make_qkv(seed, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv, device=DEVICE)
    return tuple(_bnhd(x.to(torch.bfloat16)) for x in (GROW * q, GROW * k, v))


def _fwd_bwd_check(tag: str, q, k, v, do, *, phase: str = "window", want_dbias: bool = False,
                   **kw) -> dict:
    """K1 (flash_fwd.fwd) and, unless ``do`` is None, its backward -- K3; K5 +
    K6's split route (one launch, flash_bwd.split_bwd) with segment ids or a
    softcap and no bias; K5 + K6's bias route (one launch, flash_bwd.bias_bwd,
    _bias_bwd_check) with a bias, writing dbias with ``want_dbias`` -- against
    their plain versions on f32 copies of the same bf16 inputs: O within
    FWD_TOL[bf16], LSE within 1e-3 on live rows, dQ/dK/dV (and dbias) within
    BWD_TOL[bf16], each of O, dQ, dK, dV (and dbias) within WINDOW_REL_L2
    relative L2 (printed with max|ref|), dead rows' O and dQ exactly 0 and
    their LSE exactly ln2 · mask as the kernels form it in f32; K1 on its
    route, one launch counted with its bias, window and cap: on int8 / fp8 K/V
    (``k_scale`` / ``v_scale`` in ``kw``, forward only: the plain version on
    the same 8-bit K/V and scales) the quantized route -- under an f32 q its
    f32-q form after one split of q, O within FWD_TOL[f32] and the LSE within
    F32_LSE_ATOL --, with a bias the bias
    route, without the dense route (each its D 256 form above D 128).
    Returns the max errors, dbias, and the (q, k, v, do, lse, delta) the
    backward took."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import (
        BWD_TOL, FWD_TOL, Tolerance, check_close, grad_gate)

    before = _launches()
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    variants = dict(K1_window=int(flash_fwd.kernel_window(kw.get("window")) != (-1, -1)),
                    K1_softcap=int("softcap" in kw))
    wide = int(q.shape[-1] > 128)
    f32q = q.dtype == torch.float32
    if "k_scale" in kw:  # K1's quantized route (its checks' calls are not decode-shaped)
        kv_name = "int8" if k.dtype == torch.int8 else "fp8"
        route = dict(K1_quant_f32=1, split_bf16x3=1) if f32q else dict(K1_quant_sm90=1)
        _routed(f"K1 at {tag}", before, K1=1, **route, **{f"K1_{kv_name}": 1}, **variants)
    elif "bias" in kw:  # K1's bias route (the paths' bias calls are not decode-shaped)
        _routed(f"K1 at {tag}", before, K1=1, K1_bias=1, K1_bias_sm90=1, K1_bias_d256=wide,
                **variants)
    else:  # K1's dense route
        _routed(f"K1 at {tag}", before, K1=1, K1_dense_sm90=1, K1_dense_d256=wide, **variants)
    f32 = [x.float() for x in (q, k, v) + (() if do is None else (do,))]
    o_want, lse_want = flash_fwd.fwd_reference(*f32[:3], **kw)
    live = lse_want > math.log(2.0) * DEFAULT_MASK_VALUE * 0.5
    o_tol, o_tol_name, lse_atol = ((FWD_TOL[torch.float32], "FWD_TOL[f32]", F32_LSE_ATOL) if f32q
                                   else (FWD_TOL[torch.bfloat16], O_TOL_NAME, LSE_ATOL))
    ok_o, msg_o = check_close(o, o_want, o_tol, "O")
    ok_l, msg_l = check_close(lse[live], lse_want[live], Tolerance(lse_atol, 0.0), "LSE")
    err_o = (o.float() - o_want).abs().max().item()
    dead = ~live
    dead_o = bool((o[dead] == 0).all()) and bool((lse[dead] == _dead_lse()).all())
    rel_o = _rel(o.float(), o_want) if live.any() else 0.0
    log(phase, f"{tag}: K1 O max_abs_err {err_o:.3e} (budget {o_tol_name}), relative L2 "
               f"{rel_o:.2e} (limit {WINDOW_REL_L2}) / max|ref| {o_want.abs().max().item():.3f}, "
               f"LSE live rows max_abs_err "
               f"{(lse[live] - lse_want[live]).abs().max().item() if live.any() else 0:.3e} "
               f"(budget {lse_atol}); dead rows {int(dead.sum())}, their O exactly 0 and LSE "
               f"exactly ln2 · mask: {dead_o}")
    if not (ok_o and ok_l):
        fail(f"K1 disagrees with fwd_reference at {tag}: {msg_o}; {msg_l}")
    if not rel_o <= WINDOW_REL_L2:
        fail(f"K1: O relative L2 {rel_o:.3e} above {WINDOW_REL_L2} at {tag}")
    if not dead_o:
        fail(f"dead rows at {tag}: O not exactly 0 or LSE not exactly ln2 · mask")
    if do is None:
        return {"fwd_err": err_o, "dead": int(dead.sum())}
    delta = (f32[3] * o_want.float()).sum(-1)
    args = (q, k, v, do, lse_want, delta)
    out = {"fwd_err": err_o, "args": args, "dead": int(dead.sum()), "dbias": None}
    del o, o_want
    if "bias" in kw:
        route = _bias_bwd_check(tag, args, f32, want_dbias=want_dbias, phase=phase, **kw)
        out.update(bwd_err=route["err"], dbias=route["dbias"])
        del f32
        torch.cuda.empty_cache()
        return out
    if not any(n in kw for n in ("softcap", "segment_ids")):
        before = _launches()
        got = flash_bwd_fused.bwd(*args, **kw)
        torch.cuda.synchronize()
        _routed(f"K3 at {tag}", before, K3=1, K3_sm90=1)
        want = flash_bwd_fused.bwd_reference(*f32, lse_want, delta, **kw)
        bwd_name = "K3"
    else:
        before = _launches()
        got = flash_bwd.split_bwd(*args, **kw)
        torch.cuda.synchronize()
        _routed(f"K5 + K6's split route at {tag}", before, split_bwd=1)
        want = flash_bwd.split_bwd_reference(*f32, lse_want, delta, **kw)
        bwd_name = "K5 + K6 split route"
    names = ("dq", "dk", "dv")
    g_tol = BWD_TOL[torch.bfloat16]
    ok_g, why_g, err_g, _ = grad_gate(got, want, g_tol, names=names)
    dead_dq = bool((got[0][dead] == 0).all())
    rel = {n: (_rel(a.float(), e), e.abs().max().item()) for n, a, e in zip(names, got, want)}
    log(phase, f"{tag}: {bwd_name} dQ/dK/dV max_abs_err {err_g:.3e} (budget BWD_TOL[bf16] atol "
               f"{g_tol.atol} rtol {g_tol.rtol}); relative L2 (limit {WINDOW_REL_L2}) / "
               f"max|ref|: " + ", ".join(f"{n} {r:.2e} / {m:.3f}" for n, (r, m) in rel.items())
               + f"; dead rows' dQ exactly 0: {dead_dq}")
    if not ok_g:
        fail(f"the backward disagrees with its plain version at {tag}: {why_g}")
    if not all(r <= WINDOW_REL_L2 for r, _ in rel.values()):
        fail(f"relative L2 error above {WINDOW_REL_L2} at {tag}: {rel}")
    if not dead_dq:
        fail(f"dead rows at {tag}: dQ not exactly 0")
    out["bwd_err"] = err_g
    del got, want, f32
    torch.cuda.empty_cache()
    return out


def _poison_cache(nbytes: int) -> None:
    """Leave ``nbytes`` of the caching allocator's free memory filled with
    NaN: the next large tensors that ``torch.empty`` hands out are carved
    from it, so an element a kernel leaves unwritten reads NaN, not the
    zeros of fresh device memory."""
    torch.cuda.empty_cache()
    poison = torch.full((nbytes // 4,), float("nan"), device=DEVICE)
    torch.cuda.synchronize()
    del poison


def _bias_bwd_check(tag: str, args, f32, *, want_dbias: bool, phase: str = "bias",
                    **kw) -> dict:
    """K5 + K6's bias route (flash_bwd.bias_bwd, one launch, of the dbias
    variant with ``want_dbias``, with the softcap, the window, the offsets
    and the segment ids in ``kw`` if any) on ``args`` = (q, k, v, do, lse,
    delta) against bias_bwd_reference on ``f32``, f32 copies of (q, k, v,
    do), and the same lse and delta (one launch, of the D 256 form above D
    128): dQ, dK, dV (per KV head) and dbias
    within BWD_TOL[bf16] and each within WINDOW_REL_L2 relative L2 (printed
    with max|ref|); dead rows' dQ and dbias exactly 0, and dbias exactly 0
    on every pair the masks drop (flash_fwd.pair_mask: the band, the ids,
    the KV tail), read from memory that the allocator hands out NaN-filled
    (_poison_cache), so that a pair the kernel leaves unwritten, and that
    the wrapper did not zero, fails. Returns the max error and dbias."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import BWD_TOL, grad_gate

    kw = {n: kw[n] for n in ("scale", "causal", "kv_valid_len", "bias", "softcap", "window",
                             "segment_ids", "q_offset", "kv_offset") if n in kw}
    q, k = args[:2]
    if want_dbias:
        b, hq, nq, d = q.shape
        _poison_cache(8 * (b * hq * nq * (k.shape[2] + d) + 2 * b * k.shape[1] * k.shape[2] * d))
    counts = lambda: (flash_bwd.bias_bwd.launches, flash_bwd.bias_bwd.launches_dbias,  # noqa: E731
                      flash_bwd.bias_bwd.launches_d256)
    before = counts()
    got = flash_bwd.bias_bwd(*args, want_dbias=want_dbias, **kw)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(counts(), before))
    expected = (1, int(want_dbias), int(q.shape[-1] > 128))
    want = flash_bwd.bias_bwd_reference(*f32, *args[4:], want_dbias=want_dbias, **kw)
    names = ("dq", "dk", "dv", *(("dbias",) if want_dbias else ()))
    got, want = got[:len(names)], want[:len(names)]
    g_tol = BWD_TOL[torch.bfloat16]
    ok, why, err, _ = grad_gate(got, want, g_tol, names=names)
    rel = {n: (_rel(a, e), e.abs().max().item()) for n, a, e in zip(names, got, want)}
    dead = args[4] <= math.log(2.0) * DEFAULT_MASK_VALUE * 0.5
    dead_zero = bool((got[0][dead] == 0).all()) and (
        not want_dbias or bool((got[3][dead] == 0).all()))
    masked, n_masked = 0, 0
    if want_dbias:
        nq, nk = got[3].shape[-2:]
        drop = ~flash_fwd.pair_mask(
            nq, nk, kv_valid_len=kw.get("kv_valid_len", nk), causal=kw.get("causal", False),
            segment_ids=kw.get("segment_ids"), device=DEVICE, window=kw.get("window"),
            q_offset=kw.get("q_offset", 0), kv_offset=kw.get("kv_offset", 0)
        ).expand(got[3].shape)
        masked, n_masked = int((got[3][drop] != 0).sum()), int(drop.sum())
        del drop
    log(phase, f"{tag}: K5 + K6 bias route (bias bwd / dbias / d256 launches {launched}) "
               f"dQ/dK/dV{'/dbias' if want_dbias else ''} max_abs_err {err:.3e} (budget "
               f"BWD_TOL[bf16] atol {g_tol.atol} rtol {g_tol.rtol}); relative L2 (limit "
               f"{WINDOW_REL_L2}) / max|ref|: "
               + ", ".join(f"{n} {r:.2e} / {m:.3f}" for n, (r, m) in rel.items())
               + f"; dead rows {int(dead.sum())}, their dQ{' and dbias' if want_dbias else ''} "
               f"exactly 0: {dead_zero}" + (f"; dbias on the {n_masked} pairs the masks drop: "
                                            f"{masked} not exactly 0" if want_dbias else ""))
    if launched != expected:
        fail(f"the bias route's backward launched {launched} times at {tag}, expected "
             f"{expected}")
    if not ok:
        fail(f"the bias route's backward disagrees with bias_bwd_reference at {tag}: {why}")
    if not all(r <= WINDOW_REL_L2 for r, _ in rel.values()):
        fail(f"the bias route's backward: relative L2 error above {WINDOW_REL_L2} at {tag}: "
             f"{rel}")
    if not dead_zero:
        fail(f"the bias route's backward: dead rows' dQ or dbias not exactly 0 at {tag}")
    if masked:
        fail(f"the bias route's dbias is not exactly 0 on {masked} pairs the masks drop at "
             f"{tag}")
    dbias = got[3] if want_dbias else None
    del got, want
    return {"err": err, "dbias": dbias}


def _wide_case(i: int):
    """WIDE_CASES[i]'s inputs at B1 Hq8 Hkv4 D WIDE_D: q, k (at GROW), v and
    the keyword arguments of its call (the bias: key padding plus a normal
    [1, Hq, Nq, Nk] bias)."""
    B, Hq, Hkv, D = 1, 8, 4, WIDE_D
    name, nq, nk, causal, window, ids, biased, cap, dead = WIDE_CASES[i]
    q, k, v = _grown(1070 + i, B, Hq, nq, D, nk, Hkv)
    kw = dict(scale=D ** -0.5, causal=causal)
    if window is not None:
        kw["window"] = window
    if ids is not None:
        kw["segment_ids"] = _seg_case_ids(ids, 1080 + i, B, nq, nk)
    if biased:
        gen = torch.Generator(device=DEVICE).manual_seed(1090 + i)
        kw["bias"] = _padding_bias((700,), nk) + torch.randn((1, Hq, nq, nk), generator=gen,
                                                              device=DEVICE)
    if cap is not None:
        kw["softcap"] = cap
    tag = (f"{'the D 256 bias form' if biased else 'the D 256 form'} {name}: B{B} Hq{Hq} "
           f"Hkv{Hkv} Nq{nq} Nk{nk} D{D}{' causal' if causal else ''}"
           f"{'' if window is None else f', window {window}'}"
           f"{'' if ids is None else f', {ids} ids'}"
           f"{', key padding + normal bias' if biased else ''}"
           f"{'' if cap is None else f', softcap {cap}'}")
    return q, k, v, kw, tag


def _wide_fwd_check() -> None:
    """K1 above D 128 (WIDE_CASES, then WIDE_FWD_CASES), the forward only
    (_fwd_bwd_check without dO): one launch each, of the dense route's D 256
    form without a bias and of the bias route's with one; then, after those
    numeric gates, the D 256 form's four instantiations' SASS
    (_tma_wgmma_sass: HGMMA, UTMALDG, no HMMA)."""
    B, Hq = 1, 8
    for i, (name, *_, dead) in enumerate(WIDE_CASES):
        q, k, v, kw, tag = _wide_case(i)
        out = _fwd_bwd_check(tag, q, k, v, None, **kw)
        if dead and not out["dead"]:
            fail(f"the D {WIDE_D} case {name} has no dead row")
        del q, k, v, kw
    for i, (name, d, hkv, nq, nk, causal, (qo, ko), dead) in enumerate(WIDE_FWD_CASES):
        q, k, v = _grown(1095 + i, B, Hq, nq, d, nk, hkv)
        out = _fwd_bwd_check(f"the D 256 form {name}: B{B} Hq{Hq} Hkv{hkv} Nq{nq} Nk{nk} D{d}"
                             f"{' causal' if causal else ''}, q / kv offsets {(qo, ko)}",
                             q, k, v, None, scale=d ** -0.5, causal=causal, q_offset=qo,
                             kv_offset=ko)
        if dead != bool(out["dead"]):
            fail(f"the D {d} case {name} has {out['dead']} dead rows")
        del q, k, v
    _tile_width_check()
    _tma_wgmma_sass("window", {
        f"K1 dense sm90{' segments' if sg else ''}{' softcap' if cp else ''} "
        f"fwd_dense_sm90_kernel<256, {sg}, {cp}>" for sg in (0, 1) for cp in (0, 1)})


def _tile_width_check() -> None:
    """K1's dense D 256 form at its 80-key KV tile: TILE_CASES through
    _fwd_bwd_check (forward only: FWD_TOL[bf16], LSE 1e-3, relative L2 1e-2,
    dead rows exactly 0, one launch of the D 256 form), each with the tile
    pairs it visits at 80 keys and would at 64; then K7's D 256 form on one
    chunk pair (_ring_tile_steps)."""
    from flashattn_tpu_torch.ops import flash_fwd

    for i, case in enumerate(TILE_CASES):
        name, d, hq, hkv, nq, nk, causal, window, (qo, ko), ids = case
        q, k, v = _grown(1200 + i, 1, hq, nq, d, nk, hkv)
        kw = dict(scale=d ** -0.5, causal=causal, q_offset=qo, kv_offset=ko)
        if window is not None:
            kw["window"] = window
        if ids is not None:
            kw["segment_ids"] = (tile_edge_ids(1, nq), tile_edge_ids(1, nk))
        tile = flash_fwd.dense_kv_tile(d)
        _fwd_bwd_check(f"the D 256 form at {tile}-key tiles, {name}: B1 Hq{hq} Hkv{hkv} Nq{nq} "
                       f"Nk{nk} D{d}{' causal' if causal else ''}"
                       f"{'' if window is None else f', window {window}'}"
                       f"{'' if (qo, ko) == (0, 0) else f', q / kv offsets {(qo, ko)}'}"
                       f"{'' if ids is None else ', documents ending at ' + str(TILE_EDGE_BOUNDS)}"
                       f"; tile pairs visited {tile_visits(case, tile)} (at 64 keys "
                       f"{tile_visits(case, 64)})", q, k, v, None, **kw)
        del q, k, v
    _ring_tile_steps()


def _ring_tile_steps() -> None:
    """K7's D 256 form on one RING_TILE_PAIR chunk pair (512 keys: six 80-key
    tiles and a masked partial one), rank 1's rows against rank 0's K/V at q,
    k GROW: as the rank's first live step, a middle step and its last,
    against ring_fwd_step_reference on the same inputs and state (a state the
    plain step made from the diagonal pair): the state's acc and l within
    relative L2 1e-2 and m within LSE_ATOL, the last step's O within
    FWD_TOL[bf16] and relative L2 1e-2 and its LSE within LSE_ATOL; one D 256
    launch each."""
    from flashattn_tpu_torch.parallel import ring_kernel as rk
    from flashattn_tpu_torch.utils.testing import FWD_TOL, check_close

    c, hq, hkv, d = RING_TILE_PAIR
    q, k, v = _grown(1220, 1, hq, 2 * c, d, 2 * c, hkv)
    q2 = rk._prescale(q.contiguous(), d ** -0.5)
    k, v = k.contiguous(), v.contiguous()
    rows = lambda x, r: x.narrow(2, r * c, c)  # noqa: E731
    f32 = dict(dtype=torch.float32, device=DEVICE)
    state0 = (torch.zeros((1, hq, c, d), **f32), torch.zeros((1, hq, c), **f32),
              torch.zeros((1, hq, c), **f32))
    o_ref, lse_ref = torch.empty_like(rows(q2, 1)), torch.empty((1, hq, c), **f32)
    rk.ring_fwd_step_reference(rows(q2, 1), rows(k, 1), rows(v, 1), *state0, o_ref, lse_ref,
                               q_base=c, kv_off=c, causal=True, first=True)
    for kind, flags in (("first", dict(first=True)), ("middle", {}), ("last", dict(last=True))):
        pos = dict(q_base=c, kv_off=0, causal=True, **flags)
        want, got = (tuple(x.clone() for x in state0) for _ in range(2))
        o_w, lse_w = torch.empty_like(o_ref), torch.empty_like(lse_ref)
        o_g, lse_g = torch.zeros_like(o_ref), torch.zeros_like(lse_ref)
        rk.ring_fwd_step_reference(rows(q2, 1), rows(k, 0), rows(v, 0), *want, o_w, lse_w, **pos)
        before = rk.ring_fwd_step.launches_d256
        rk.ring_fwd_step(rows(q2, 1), rows(k, 0), rows(v, 0), *got, o_g, lse_g, **pos)
        torch.cuda.synchronize()
        if rk.ring_fwd_step.launches_d256 != before + 1:
            fail(f"K7's D 256 form was not launched once at the {kind} step")
        tag = f"K7 D 256 at 80-key tiles, the {kind} step of a {c} x {c} pair, Hq{hq} Hkv{hkv}"
        if kind == "last":
            ok_o, msg_o = check_close(o_g, o_w, FWD_TOL[torch.bfloat16], "O")
            errs = {"O": (o_g.float() - o_w.float()).abs().max().item(),
                    "O relative L2": _rel(o_g.float(), o_w.float()),
                    "LSE": (lse_g - lse_w).abs().max().item()}
            ok = ok_o and errs["O relative L2"] <= WINDOW_REL_L2 and errs["LSE"] <= LSE_ATOL
        else:
            errs = {"acc relative L2": _rel(got[0], want[0]),
                    "m": (got[1] - want[1]).abs().max().item(),
                    "l relative L2": _rel(got[2], want[2])}
            msg_o = ""
            ok = (errs["acc relative L2"] <= WINDOW_REL_L2 and errs["m"] <= LSE_ATOL
                  and errs["l relative L2"] <= WINDOW_REL_L2)
        log("window", f"{tag}: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (limits relative L2 {WINDOW_REL_L2}, m / LSE {LSE_ATOL}, O {O_TOL_NAME})")
        if not ok:
            fail(f"{tag} disagrees with ring_fwd_step_reference: {errs} {msg_o}")


def phase_window_check() -> dict:
    """The sliding-window and soft-capped variants against their plain
    versions (_fwd_bwd_check), all on q, k scaled by GROW: K1 and K3 with
    each window of WINDOW_CASES; K1 and K5 + K6's split route with a window
    and segment ids, without and with softcap 50, and with segment ids and
    the softcap without a window; K1 and the split route at D 40 with cap 5
    (CAP_D40_CASE: a D 64 instantiation reading zeros past D, the cap
    saturating); K1 alone above D 128 (_wide_fwd_check): at D 160 with the
    cap, the cap and a window and / or segment ids (the dense route's D 256
    form), a bias, the cap and a bias (the bias route's) (WIDE_CASES), and the
    D 256 form at a ring's chunk pair, with dead rows, at D 136 ragged GQA
    and at one query row (WIDE_FWD_CASES), each one launch; K1 and the split
    route with softcap 50 and the SWA window at bench_lm's long shape (every
    capped K1 on its dense route); K1 with softcap and the cache-slot bias at
    bench_decode's shape, GQA-folded. Times each at the path's shape beside
    its plain version and its library call, the kernels with a window beside
    the same kernel full-causal (gated on their device times behind a
    backlog, queued_ms: at most 0.6x), and prints the tile
    pairs each visits."""
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
    # Packed documents with a window, without and with softcap, and with the
    # softcap alone: K1 with the window and segment ids (its dense route, with
    # and without the cap) and K5 + K6's split route, at bench_lm's packed
    # shape.
    B, Hq, Hkv, N, _, D = SEG_CASES[0][1:7]
    ids = packed_ids(B, N + 1)[:, :N]
    for cap, window in ((None, (GATE_WINDOW - 1, -1)), (SOFTCAP, (GATE_WINDOW - 1, -1)),
                        (SOFTCAP, None)):
        q, k, v = _grown(1050, B, Hq, N, D, N, Hkv)
        do = _bnhd(make_qkv(1051, B, Hq, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
        kw = dict(scale=D ** -0.5, causal=True, segment_ids=(ids, ids),
                  **({} if window is None else {"window": window}),
                  **({} if cap is None else {"softcap": cap}))
        _fwd_bwd_check(f"packed B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal, 8 documents per row"
                       f"{'' if window is None else f', window {window}'}"
                       f"{'' if cap is None else f', softcap {cap}'}", q, k, v, do, **kw)
        del q, k, v, do
    B, Hq, Hkv, N, D, cap = CAP_D40_CASE
    q, k, v = _grown(1060, B, Hq, N, D, N, Hkv)
    do = _bnhd(make_qkv(1061, B, Hq, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    _fwd_bwd_check(f"D{D} B{B} Hq{Hq} Hkv{Hkv} N{N} causal, softcap {cap}", q, k, v, do,
                   scale=D ** -0.5, causal=True, softcap=cap)
    del q, k, v, do
    _wide_fwd_check()

    (q, k, v, do, lse, delta), kw, k1_err, k3_err = swa
    B, Hq, Hkv, N, _, D = WINDOW_CASES[0][1:7]
    wl = kw["window"][0]
    mask = dict(kv_valid_len=N, causal=True, segment_ids=None, window=kw["window"])
    band = flash_fwd.pair_mask(N, N, device=DEVICE, **mask)[0, 0]
    stats = 4 * B * Hq * N
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
          # out: dQ, dK, dV as the function returns them (bf16; dK / dV at Hkv heads)
          **bound(tensor_bytes(*args) + tensor_bytes(q, k, v),
                  pair_flops(q, k, matmuls=5, **mask)),
          "library_ms": sdpa_ms(q, k, v, do=do, attn_mask=band),
          "library_call": "the backward of scaled_dot_product_attention(attn_mask=band)"}
    k3_full = cuda_ms(lambda: flash_bwd_fused.bwd(*args, **full))
    # The gate reads device times (queued_ms): the calls' CUDA-event times
    # above read the host's time per call where it exceeds the kernels', and
    # on a slow host that brought K1 windowed to 0.92x full causal.
    device = {"K1": (queued_ms(lambda: flash_fwd.fwd(q, k, v, **kw)),
                     queued_ms(lambda: flash_fwd.fwd(q, k, v, **full))),
              "K3": (queued_ms(lambda: flash_bwd_fused.bwd(*args, **kw)),
                     queued_ms(lambda: flash_bwd_fused.bwd(*args, **full)))}
    # K1's dense route: Q tiles of 128 rows, KV tiles of 64; K3: KV tiles of
    # 128 rows, Q tiles of 64 (csrc/fwd_sm90_tile.cuh, bwd_sm90_tile.cuh).
    tiles = {"K1": (band_tiles(N, N, 128, 64, wl, 0), band_tiles(N, N, 128, 64, None, 0)),
             "K3": (band_tiles(N, N, 128, 64, 0, wl), band_tiles(N, N, 128, 64, 0, None))}
    for name, res_k, full_ms in (("K1", k1, k1_full), ("K3", k3, k3_full)):
        visited, causal_pairs = tiles[name]
        dev, dev_full = device[name]
        log("window", f"{name} window {kw['window']} causal at B{B} Hq{Hq} Hkv{Hkv} N{N} D{D}: "
                      f"{res_k['ms']:.4f} ms vs {name} full causal {full_ms:.4f} ms "
                      f"({res_k['ms'] / full_ms:.3f}x); device time behind a backlog "
                      f"{dev:.4f} ms vs {dev_full:.4f} ms ({dev / dev_full:.3f}x, gate 0.6x); "
                      f"tile pairs per head "
                      f"{visited} vs full causal {causal_pairs} ({visited / causal_pairs:.3f}); "
                      f"plain {res_k['plain_ms']:.4f} ms, bound {res_k['bound_ms']:.4f} ms "
                      f"({res_k['bound_by']}), SDPA with the band mask {res_k['library_ms']:.4f} ms")
        if not dev <= 0.6 * dev_full:
            fail(f"{name} with window {kw['window']} takes {dev:.4f} ms of device time, more "
                 f"than 0.6x {name} full causal ({dev_full:.4f} ms)")
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
    # In: q, k, v, dO, LSE, Delta; out: dQ, dK, dV as the function returns
    # them (bf16; dK / dV at Hkv heads).
    res["split_softcap"] = {"max_abs_err": out["bwd_err"],
                            "ms": cuda_ms(lambda: flash_bwd.split_bwd(*args, **kw)),
                            "plain_ms": cuda_ms(
                                lambda: flash_bwd.split_bwd_reference(*args, **kw), reps=2,
                                trials=3),
                            **bound(tensor_bytes(*args) + tensor_bytes(q, k, v),
                                    pair_flops(q, k, matmuls=5, **mask)), **bwd_library}
    sc = res["split_softcap"]
    log("window", f"softcap at the SWA shape: K1's dense route {res['k1_softcap']['ms']:.4f} ms "
                  f"(bound {res['k1_softcap']['bound_ms']:.4f} {res['k1_softcap']['bound_by']}; plain "
                  f"{res['k1_softcap']['plain_ms']:.4f}, flex_attention "
                  f"{ms_text(fwd_library['library_ms'])}), K5 + K6 split route {sc['ms']:.4f} ms "
                  f"({pair_flops(q, k, matmuls=5, **mask) / 1e9 / sc['ms']:.1f} TFLOP/s; plain "
                  f"{sc['plain_ms']:.4f}, bound {sc['bound_ms']:.4f} {sc['bound_by']}), "
                  f"flex_attention's backward {ms_text(bwd_library['library_ms'])} ms; K1 window "
                  f"without the cap {k1['ms']:.4f} ms, K3 window {k3['ms']:.4f} ms (median "
                  "CUDA-event time)")
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
                  f"{ms_text(res['k1_softcap_bias']['library_ms'])} ms")
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
    log("swa", f"launches during the windowed steps: {counts} (expected K1 = K1 window = K1 "
               f"dense sm90 = K3 = K3 sm90 = {cfg.n_layers} layers x {LM_STEPS} steps = {n}, no "
               "other)")
    if counts != _expect(K1=n, K1_window=n, K1_dense_sm90=n, K3=n, K3_sm90=n):
        fail(f"SWA steps launched {counts}, expected K1 = K1 window = K1 dense sm90 = K3 = K3 "
             f"sm90 = {n} and no other")

    cfg = dataclasses.replace(cfg, remat=True)
    tokens = torch.randint(0, cfg.vocab_size, (1, SWA_REMAT_SEQ + 1), generator=gen,
                           device=DEVICE)
    _reset_launches()
    _lm_steps(cfg, tokens, "fused", phase="swa", label=f"fused, sliding_window {SWA_WINDOW}, remat",
              steps=SWA_REMAT_STEPS, warmup=1)
    remat = _launches()
    n = cfg.n_layers * SWA_REMAT_STEPS
    log("swa", f"launches during the remat steps: {remat} (expected K1 = K1 window = K1 dense "
               f"sm90 = 2 x {n} (forward and its recomputation), K3 = K3 sm90 = {n})")
    if remat != _expect(K1=2 * n, K1_window=2 * n, K1_dense_sm90=2 * n, K3=n, K3_sm90=n):
        fail(f"SWA remat steps launched {remat}, expected K1 = K1 window = K1 dense sm90 = "
             f"{2 * n}, K3 = K3 sm90 = {n}")
    return counts


def phase_softcap() -> dict:
    """Soft-capped training and decode. Training: the LM with logit_softcap
    50 and sliding_window 512, gates at [1, 2049] as phase_swa_train's; then
    LM_STEPS fused steps at [1, 8193] with the cap and sliding_window 2048:
    exactly K1 = K1 dense sm90 = K1 window = K1 softcap = split bwd (K5 +
    K6's split route) = layers x steps, no other (no bias or quantized K1, no K3).
    Decode: bench_decode's LM with the cap and sliding_window 2048 on a bf16
    cache, decode against the teacher-forced forward (_decode_gate; the
    forward runs K1 with the window and the cap), ms/token at cache lengths
    1024-8192 with exactly 16 K1 softcap launches per step, all on the
    decode kernel without a bias. Returns both paths' launch counts."""
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
    log("softcap", f"launches during the soft-capped steps: {train} (expected K1 = K1 dense sm90 "
                   f"= K1 window = K1 softcap = split bwd = {n}, no other)")
    if train != _expect(K1=n, K1_dense_sm90=n, K1_window=n, K1_softcap=n, split_bwd=n):
        fail(f"soft-capped steps launched {train}, expected K1 = K1 dense sm90 = K1 window = K1 "
             f"softcap = split bwd = {n} and no other")

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
    per_len = cfg.n_layers * (DECODE_WARMUP + DECODE_STEPS)
    n = per_len * len(DECODE_CACHE_LENS)
    # The live slots of a step held at cache_len // 2: the window's, at most.
    merges = per_len * sum(_decode_merges(DECODE_B, cfg.n_kv_heads,
                                          min(cache_len // 2 + 1, SWA_WINDOW))
                           for cache_len in DECODE_CACHE_LENS)
    log("softcap", f"launches during the soft-capped decode steps: {decode} (expected "
                   f"{cfg.n_layers} per step, K1 = K1 softcap = K1 decode = {n}, no bias, "
                   f"{merges} merges, no dense K1)")
    if decode != _expect(K1=n, K1_softcap=n, K1_decode=n, K1_merge=merges):
        fail(f"soft-capped decode launched {decode}, expected K1 = K1 softcap = K1 decode = "
             f"{n}, K1 merge = {merges}")
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
# K1's bias route and its backward beside path A's and the LM's biases
# (phase_bias_check): (tag, B, Hq, Hkv, Nq, Nk, D, kv_valid_len, causal, bias
# kind, softcap) -- a row-broadcast [B, 1, 1, Nk] key mask, a ragged Nq with
# kv_valid_len < Nk (causal, GQA, a [B, Hq, Nq, Nk] bias), D 64 with a
# key-padding bias [B, 1, N, N] of dead rows, Nk 2046, whose bias rows the
# wrapper pads to 16 bytes (its last copy reads the two live columns of a
# 4-column chunk), D 96 and a ragged causal GQA D 40 with cap 5 (run in the
# D 128 / D 64 instantiations, boxes reading zeros past D), and the GQA
# decode fold's call with cap 50 (Hq16 / Hkv8 at Nq 2 folded into 4 rows of
# each KV head, its [B, 1, Nq, Nk] bias repeated per query head: the decode
# kernel forward, the bias route backward).
BIAS_ROUTE_CASES = [("row-broadcast", 4, 16, 16, 2048, 2048, 128, 2048, False, "keys", None),
                    ("ragged", 2, 16, 8, 1000, 2048, 128, 1500, True, "full", None),
                    ("D64", 2, 8, 8, 1536, 1536, 64, 1536, False, "padding", None),
                    ("Nk 2046", 2, 16, 16, 1024, 2046, 128, 2046, False, "full", None),
                    ("D96", 2, 16, 16, 2048, 2048, 96, 2048, False, "padding", None),
                    ("D40 ragged", 2, 8, 4, 1000, 1500, 40, 1300, True, "full", 5.0),
                    ("decode fold", 2, 8, 8, 4, 2048, 128, 2048, False, "rows", SOFTCAP)]
# phase_roofline: K9 at 4096^3 and at the JAX test's 512 x 256 x 384; K10
# checked at size 256 with 4 iterations and timed at the JAX probe's default
# (size 512, 1024 iterations); the chained torch.matmul at size 4096.
GEMM_SHAPES = ((4096, 4096, 4096), (512, 256, 384))
# Checked beside them: N = 384, so K9's second 256-wide tile hangs over N.
GEMM_TAIL_SHAPE = (512, 384, 256)
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


def _bias_route_case(seed: int, B, Hq, Hkv, Nq, Nk, D, kind):
    """q, k (GROW) and v as _grown gives them, and the case's f32 bias: "keys"
    a [B, 1, 1, Nk] key mask (each batch row's last keys at the mask value)
    plus a normal draw, "full" a normal [B, Hq, Nq, Nk], "rows" a normal
    [B, 1, Nq / 2, Nk] repeated twice along the rows (the decode fold's),
    "padding" the key-padding bias [B, 1, N, N] of lengths (N, 0.45 N)."""
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE

    q, k, v = _grown(seed, B, Hq, Nq, D, Nk, Hkv)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    if kind == "padding":
        return q, k, v, _padding_bias((Nq, int(0.45 * Nq)), Nq)
    if kind == "keys":
        bias = torch.randn((B, 1, 1, Nk), generator=gen, device=DEVICE)
        cut = torch.arange(Nk, device=DEVICE) >= Nk - 64 * (1 + torch.arange(B, device=DEVICE))[
            :, None]
        return q, k, v, torch.where(cut[:, None, None], DEFAULT_MASK_VALUE, bias)
    if kind == "rows":
        return q, k, v, torch.randn((B, 1, Nq // 2, Nk), generator=gen,
                                    device=DEVICE).repeat(1, 1, 2, 1)
    return q, k, v, torch.randn((B, Hq, Nq, Nk), generator=gen, device=DEVICE)


def _bias_route_check(tag: str, q, k, v, **kw) -> float:
    """K1 with a bias -- one launch, of the sm90 bias kernel, or of the decode
    kernel (and its merge, with more than one split) where decode_route
    takes the call, counted with its bias and cap -- against fwd_reference on
    f32 copies of the same bf16 inputs: O within FWD_TOL[bf16] and relative
    L2 WINDOW_REL_L2, LSE within LSE_ATOL on live rows, dead rows' O exactly
    0. Returns O's max error."""
    from flashattn_tpu_torch.ops import flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import FWD_TOL, Tolerance, check_close

    b, hq, nq, d = q.shape
    hkv = k.shape[1]
    if flash_fwd.decode_route(rows=hq // hkv * nq, causal=kw.get("causal", False),
                              segment_ids=None, window=None, head_dim=d):
        route, where = dict(K1_decode=1, K1_merge=_decode_merges(b, hkv, kw["kv_valid_len"])), \
            "the decode kernel"
    else:
        route, where = dict(K1_bias_sm90=1), "the bias route"
    before = _launches()
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    _routed(f"K1 at {tag}", before, K1=1, K1_bias=1, K1_softcap=int("softcap" in kw), **route)
    o_want, lse_want = flash_fwd.fwd_reference(q.float(), k.float(), v.float(), **kw)
    live = lse_want > math.log(2.0) * DEFAULT_MASK_VALUE * 0.5
    ok_o, msg_o = check_close(o, o_want, FWD_TOL[torch.bfloat16], "O")
    ok_l, msg_l = check_close(lse[live], lse_want[live], Tolerance(LSE_ATOL, 0.0), "LSE")
    err_o = (o.float() - o_want).abs().max().item()
    rel = _rel(o.float(), o_want)
    dead_zero = bool((o[~live] == 0).all())
    log("bias", f"{tag}: K1 on {where}, O max_abs_err "
                f"{err_o:.3e} (budget {O_TOL_NAME}), relative L2 {rel:.2e} (limit "
                f"{WINDOW_REL_L2}) / max|ref| {o_want.abs().max().item():.3f}, LSE live rows "
                f"max_abs_err "
                f"{(lse[live] - lse_want[live]).abs().max().item():.3e} (budget {LSE_ATOL}); "
                f"dead rows {int((~live).sum())}, their O exactly 0: {dead_zero}")
    if not (ok_o and ok_l):
        fail(f"K1 with a bias disagrees with fwd_reference at {tag}: {msg_o}; {msg_l}")
    if not rel <= WINDOW_REL_L2:
        fail(f"K1 with a bias: O relative L2 {rel:.3e} above {WINDOW_REL_L2} at {tag}")
    if not dead_zero:
        fail(f"K1 with a bias: dead rows' O not exactly 0 at {tag}")
    del o, lse, o_want, lse_want
    torch.cuda.empty_cache()
    return err_o


def bias_route_instantiations(*, seg: bool) -> set:
    """The instantiations of K1's bias route (fwd_bias_sm90_kernel<D, SEG,
    CAP>) and of K5 + K6's (bwd_bias_sm90_kernel<D, DBIAS, CAP, SEG>) with or
    without segment ids, as instantiation_name names them: 4 + 8."""
    sg = int(seg)
    tag = " segments" if seg else ""
    return ({f"K1 bias sm90{tag}{' softcap' if c else ''} fwd_bias_sm90_kernel<{d}, {sg}, {c}>"
             for d in (64, 128) for c in (0, 1)}
            | {f"bias bwd sm90{tag}{' softcap' if c else ''} "
               f"bwd_bias_sm90_kernel<{d}, {w}, {c}, {sg}>"
               for d in (64, 128) for w in (0, 1) for c in (0, 1)})


def _tma_wgmma_sass(phase: str, names: set) -> None:
    """The SASS (cuobjdump) of the TMA + wgmma instantiations ``names``:
    HGMMA (wgmma), UTMALDG (TMA loads) and no HMMA (mma.sync); their
    registers and spills from the build's ptxas report when phase_build ran."""
    from flashattn_tpu_torch.utils import native

    ops = sass_opcodes(native.BUILD_DIR / native.LIB_NAME, names)
    for name in sorted(names):
        c = ops.get(name, collections.Counter())
        regs = BUILD_STATS.get(name)
        log(phase, f"{name}: {c['HGMMA']} HGMMA, {c['UTMALDG']} UTMALDG, {c['HMMA']} HMMA, "
                   f"{sum(c.values())} SASS instructions; " + (
                       f"registers, stack, spill stores / loads {regs}" if regs
                       else "no ptxas report in this run"))
        if not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"]:
            fail(f"{name}: {c['HGMMA']} HGMMA, {c['UTMALDG']} UTMALDG and {c['HMMA']} HMMA, "
                 "expected TMA loads and wgmma only")


def phase_bias_check() -> dict:
    """K1 with a bias, with and without the softcap, and K5 + K6's bias route
    (one kernel for both, with and without dbias and the cap) against their
    plain versions (_fwd_bwd_check, q and k scaled by GROW; every K1 call on
    the bias route, every backward one launch of the route): at path A's
    attention (B4 H16 N2048 D128 non-causal) with its mask arm's bias (the
    key-padding bias [4, 1, N, N] of ATTN_LENGTHS, with dead rows; no dbias,
    as a mask wants none) and at D 96; with its learned arm's (that bias plus
    a learned [1, 16, N, N] one, [4, 16, N, N], with dbias), without and with
    softcap 50; at the LM's attention shape B2 Hq16 Hkv8 N2048 D128 causal
    with a learned [1, 16, N, N] bias, without and with softcap 50 (dbias,
    exactly 0 above the diagonal). The route is also held alone
    (_bias_route_check, and its backward with dbias, _bias_bwd_check) on
    BIAS_ROUTE_CASES (D 96, D 40 with a cap, the decode fold among them).
    Then flash_attention(bias=) end to end against autograd through the f32
    oracle (_bias_e2e): the learned bias, a trainable [2, 1, 1, N] padding
    bias, softcap + the learned bias, and the GQA decode fold with a [B, 1,
    Nq, Nk] bias, whose repeated rows sum back: 3 launches of K1's bias
    route (the fold's forward is the decode kernel's), 4 of the route's
    backward, all with dbias, no K3 and no split route. After the numeric
    gates the two Hopper bias kernels' SASS has wgmma and no mma.sync. Times
    K1 on both arms' biases (beside K1's dense route without a bias at that
    shape) and with the cap, the route's backward on both arms, with the cap
    (with and without dbias) and at D 96, beside their plain versions, SDPA's
    backward (flex_attention's with the cap), and the route at the causal
    shape."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
    from flashattn_tpu_torch.utils.testing import make_qkv

    res = {}
    B, N = len(ATTN_LENGTHS), ATTN_SEQ
    H = ATTN_WIDTH["num_heads"]
    D = ATTN_WIDTH["qkv_features"] // H
    pad = _padding_bias(ATTN_LENGTHS, N)
    stats = 4 * B * H * N
    mask = dict(kv_valid_len=N, causal=False, segment_ids=None)
    flops = {}
    for d in (D, 96):
        q, k, v = _grown(1400 if d == D else 1430, B, H, N, d, N, H)
        do = _bnhd(make_qkv(1401 if d == D else 1431, B, H, N, d, dtype=torch.bfloat16,
                            device=DEVICE)[0])
        kw = dict(scale=d ** -0.5, bias=pad)
        _reset_launches()
        out = _fwd_bwd_check(f"path A's attention B{B} H{H} N{N} D{d} non-causal, key-padding "
                             f"bias [{B}, 1, {N}, {N}] of lengths {ATTN_LENGTHS}", q, k, v, do,
                             phase="bias", **kw)
        if not out["dead"]:
            fail("the key-padding case has no dead row")
        args = out["args"]
        res[f"launches_d{d}"] = _launches()["bias bwd"]
        flops[d] = pair_flops(q, k, matmuls=5, **mask)
        bwd_library = dict(library_ms=sdpa_ms(q, k, v, do=do, attn_mask=pad), library_call=(
            "the backward of scaled_dot_product_attention(attn_mask=the key-padding bias) (dQ, "
            "dK and dV in one call)"))
        # K5 + K6's bias route, the backward path A takes: 5 products; dQ, dK,
        # dV out as the function returns them (bf16; dK / dV at Hkv heads).
        res["bias_bwd" if d == D else "bias_bwd_d96"] = {
            "max_abs_err": out["bwd_err"],
            "ms": cuda_ms(lambda: flash_bwd.bias_bwd(*args, **kw)),
            "plain_ms": cuda_ms(lambda: flash_bwd.bias_bwd_reference(*args, **kw), reps=2,
                                trials=3),
            **bound(tensor_bytes(*args, pad) + tensor_bytes(q, k, v), flops[d]),
            **bwd_library}
        if d == D:
            res["k1_bias"] = {
                "max_abs_err": out["fwd_err"], "ms": cuda_ms(lambda: flash_fwd.fwd(q, k, v, **kw)),
                "plain_ms": cuda_ms(lambda: flash_fwd.fwd_reference(q, k, v, **kw), reps=3,
                                    trials=3),
                **bound(tensor_bytes(q, k, v, pad, q) + stats,
                        pair_flops(q, k, matmuls=2, **mask)),
                "library_ms": sdpa_ms(q, k, v, attn_mask=pad),
                "library_call": "scaled_dot_product_attention(attn_mask=the key-padding bias)",
                # K1's dense route (flash_fwd_sm90.cu) without a bias at this shape: the
                # shared body's cost apart from the bias's.
                "dense_sm90_no_bias_ms": cuda_ms(lambda: flash_fwd.fwd(q, k, v, scale=d ** -0.5))}
        del q, k, v, do, args, out
        torch.cuda.empty_cache()
    log("bias", f"path A's attention: K1 bias sm90 {res['k1_bias']['ms']:.4f} ms (plain "
                f"{res['k1_bias']['plain_ms']:.4f}, SDPA {res['k1_bias']['library_ms']:.4f}, bound "
                f"{res['k1_bias']['bound_ms']:.4f} {res['k1_bias']['bound_by']}; K1's dense route "
                f"without a bias {res['k1_bias']['dense_sm90_no_bias_ms']:.4f}); K5 + K6's bias "
                + "; ".join(f"route at D {d} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                            f"{r['bound_ms']:.4f} {r['bound_by']}, {flops[d] / r['ms'] / 1e9:.0f} "
                            f"TFLOP/s; SDPA's backward {r['library_ms']:.4f})"
                            for d, r in ((D, res["bias_bwd"]), (96, res["bias_bwd_d96"])))
                + " (median CUDA-event time)")

    # Path A's learned arm: flash_attention_fn adds the key-padding bias and
    # the learned relative-position bias [1, H, N, N] into one [B, H, N, N] f32
    # bias that requires grad, so the route writes dbias over every pair;
    # then the same with Gemma-2's cap.
    gen = torch.Generator(device=DEVICE).manual_seed(1409)
    combined = pad + torch.randn((1, H, N, N), generator=gen, device=DEVICE)
    del pad
    q, k, v = _grown(1410, B, H, N, D, N, H)
    do = _bnhd(make_qkv(1411, B, H, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    for cap in (None, SOFTCAP):
        kw = dict(scale=D ** -0.5, bias=combined, **({} if cap is None else {"softcap": cap}))
        out = _fwd_bwd_check(f"path A's learned arm B{B} H{H} N{N} D{D} non-causal, bias [{B}, "
                             f"{H}, {N}, {N}] (key padding + learned [1, {H}, {N}, {N}])"
                             f"{'' if cap is None else f', softcap {cap}'}, dbias", q, k, v, do,
                             phase="bias", want_dbias=True, **kw)
        args = out["args"]
        k1_ms = cuda_ms(lambda: flash_fwd.fwd(q, k, v, **kw))
        # The route with dbias: the whole [B, H, N, N] f32 bias read and dbias
        # written; dQ, dK, dV as the function returns them.
        row = {"max_abs_err": out["bwd_err"],
               "ms": cuda_ms(lambda: flash_bwd.bias_bwd(*args, want_dbias=True, **kw)),
               "plain_ms": cuda_ms(lambda: flash_bwd.bias_bwd_reference(*args, want_dbias=True,
                                                                        **kw),
                                   reps=2, trials=3),
               "no_dbias_ms": cuda_ms(lambda: flash_bwd.bias_bwd(*args, **kw)),
               **bound(tensor_bytes(*args, combined, out["dbias"]) + tensor_bytes(q, k, v),
                       pair_flops(q, k, matmuls=5, **mask))}
        if cap is None:
            # SDPA takes a bias that requires grad only in the query's dtype.
            leaf = combined.to(torch.bfloat16).requires_grad_(True)
            row.update(library_ms=sdpa_ms(q, k, v, do=do, attn_mask=leaf, bias_leaf=leaf),
                       library_call=(
                           "the backward of scaled_dot_product_attention(attn_mask=the [B, H, "
                           "N, N] bias in bf16, which requires grad) (dQ, dK, dV and dbias in "
                           "one call)"))
            del leaf
            res["bias_bwd_dbias"] = row
            # Its bound counts the whole [B, H, N, N] f32 bias, 1.07 GB.
            res["k1_bias_learned"] = {
                "max_abs_err": out["fwd_err"], "ms": k1_ms,
                "plain_ms": cuda_ms(lambda: flash_fwd.fwd_reference(q, k, v, **kw), reps=3,
                                    trials=3),
                **bound(tensor_bytes(q, k, v, combined, q) + stats,
                        pair_flops(q, k, matmuls=2, **mask)),
                "library_ms": sdpa_ms(q, k, v, attn_mask=combined),
                "library_call": "scaled_dot_product_attention(attn_mask=the [B, H, N, N] f32 bias)"}
        else:
            row.update(library_ms=flex_ms(q, k, v, do=do, scale=kw["scale"],
                                          score_mod=softcap_mod(cap, combined)),
                       library_call=("the backward of flex_attention (torch.compile) with the "
                                     "softcap and bias score_mod (dQ, dK and dV; no dbias: the "
                                     "bias it reads does not require grad)"),
                       k1_ms=k1_ms)
            res["bias_bwd_softcap"] = row
        log("bias", f"path A's learned arm{'' if cap is None else f', softcap {cap}'}: K1 bias "
                    f"sm90 {k1_ms:.4f} ms; K5 + K6's bias route with dbias {row['ms']:.4f} ms "
                    f"(plain {row['plain_ms']:.4f}), without dbias {row['no_dbias_ms']:.4f} ms; "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); library "
                    f"{ms_text(row['library_ms'])} ms ({row['library_call']})")
        del args, out
        torch.cuda.empty_cache()
    del q, k, v, do, combined
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
            fail(f"the route's dbias is not exactly 0 above the causal diagonal (cap {cap})")
        if cap is None:
            args = out["args"]
            route = cuda_ms(lambda: flash_bwd.bias_bwd(*args, want_dbias=True, **kw))
            log("bias", f"learned bias B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal: K5 + K6's bias "
                        f"route with dbias {route:.4f} ms")
            del args
        del q, k, v, do, out
        torch.cuda.empty_cache()

    for i, case in enumerate(BIAS_ROUTE_CASES):
        tag, b, hq, hkv, nq, nk, d, valid, causal, kind, cap = case
        q, k, v, bias = _bias_route_case(1420 + 2 * i, b, hq, hkv, nq, nk, d, kind)
        what = (f"{tag}: B{b} Hq{hq} Hkv{hkv} Nq{nq} Nk{nk} D{d} kv_valid_len {valid}"
                f"{' causal' if causal else ''}, bias {list(bias.shape)}"
                f"{'' if cap is None else f', softcap {cap}'}")
        rkw = dict(scale=d ** -0.5, kv_valid_len=valid, causal=causal, bias=bias,
                   **({} if cap is None else {"softcap": cap}))
        _bias_route_check(f"K1 with a bias, {what}", q, k, v, **rkw)
        # The route's backward with dbias, on the plain forward's LSE and Delta.
        do = _bnhd(make_qkv(1440 + i, b, hq, nq, d, dtype=torch.bfloat16, device=DEVICE)[0])
        f32 = [x.float() for x in (q, k, v, do)]
        o_ref, lse_ref = flash_fwd.fwd_reference(*f32[:3], **rkw)
        _bias_bwd_check(f"the bias route's backward, {what}, dbias",
                        (q, k, v, do, lse_ref, (f32[3] * o_ref).sum(-1)), f32,
                        want_dbias=True, **rkw)
        del q, k, v, bias, do, f32, o_ref, lse_ref
    torch.cuda.empty_cache()

    # End to end at unit scale: these gradients also carry the bf16 rounding
    # of O and of Delta = rowsum(dO * O), which at GROW scale alone exceeds
    # BWD_TOL[bf16] elementwise (dQ off by 9.8e-2 at |ref| 6.4e-2 on the H100).
    # Each call's launches are counted from 0, then summed.
    def counted(*args, **fkw):
        _reset_launches()
        out = _bias_e2e(*args, **fkw)
        return out, _launches()

    q, k, v = (_bnhd(x) for x in make_qkv(1405, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                           device=DEVICE))
    do = _bnhd(make_qkv(1406, B, Hq, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    dbias, n_learned = counted(f"learned bias [1, {Hq}, {N}, {N}], B{B} Hq{Hq} Hkv{Hkv} causal",
                               q, k, v, learned, do, causal=True)
    if (dbias[..., upper] != 0).any():
        fail("the reduced dbias is not exactly 0 above the causal diagonal")
    lengths = torch.tensor([N, 3 * N // 4], device=DEVICE)
    slots = torch.where(torch.arange(N, device=DEVICE)[None] < lengths[:, None], 0.0, -1e9)
    _, n_slots = counted(f"trainable padding bias [{B}, 1, 1, {N}], causal", q, k, v,
                         slots[:, None, None], do, causal=True)
    _, res["e2e_softcap"] = counted(f"softcap {SOFTCAP} + learned bias, causal", q, k, v,
                                    learned, do, causal=True, logit_softcap=SOFTCAP)
    nq = 2  # rep * Nq = 4 rows per KV head: folded
    qd = _bnhd(make_qkv(1407, B, Hq, nq, D, dtype=torch.bfloat16, device=DEVICE)[0])
    dod = _bnhd(make_qkv(1408, B, Hq, nq, D, dtype=torch.bfloat16, device=DEVICE)[0])
    rows = torch.randn((B, 1, nq, N), generator=gen, device=DEVICE)
    _, n_fold = counted(f"GQA decode fold Nq{nq}, bias [{B}, 1, {nq}, {N}] (rows repeated per "
                        "q head)", qd, k, v, rows, dod)
    res["e2e"] = {n: n_learned[n] + n_slots[n] + res["e2e_softcap"][n] + n_fold[n]
                  for n in n_learned}
    log("bias", f"launches during the end-to-end checks: {res['e2e']}")
    # K1's bias route (the learned, the padding and the capped bias; the fold's
    # forward is the decode kernel's) and its backward on all four, with dbias.
    e2e = {n: res["e2e"][n] for n in ("K1 bias sm90", "K1 decode", "bias bwd", "bias bwd dbias",
                                      "K3", "split bwd")}
    want = {"K1 bias sm90": 3, "K1 decode": 1, "bias bwd": 4, "bias bwd dbias": 4, "K3": 0,
            "split bwd": 0}
    if e2e != want:
        fail(f"the end-to-end bias checks launched {res['e2e']}, expected {want}")
    _tma_wgmma_sass("bias", bias_route_instantiations(seg=False))
    return res


# phase_bias_band_check: the bias routes with a band, segment ids and q / kv
# offsets at B2 Hq8 Hkv4 (GQA: dK / dV summed per KV head), each case at D 64
# and D 128: (tag, Nq, Nk, causal, window, ids, (q_offset, kv_offset), bias
# kind, softcap, dbias, has dead rows). Bias kinds as _band_bias makes them:
# "mask" path A's mask arm (key padding [B, 1, N, N] of lengths (N, 0.45 N):
# dead rows), "learned" its learned arm (that plus a normal [1, Hq, N, N]),
# "keys" a row-broadcast [B, 1, 1, Nk], "full" a normal [B, Hq, Nq, Nk].
# "docs": 8 documents a row (packed_ids) whose document 3 no key carries
# (its rows dead, its keys unread).
BAND_WINDOW = (256, 256)  # Longformer's attention_window of 512
BAND_CASES = [
    ("window, mask arm", 2048, 2048, False, BAND_WINDOW, None, (0, 0), "mask", None, False, True),
    ("window, learned arm", 2048, 2048, False, BAND_WINDOW, None, (0, 0), "learned", None, True,
     True),
    ("window, learned arm, softcap", 2048, 2048, False, BAND_WINDOW, None, (0, 0), "learned",
     SOFTCAP, True, True),
    ("causal window, mask arm", 2048, 2048, True, (256, -1), None, (0, 0), "mask", None, False,
     True),
    ("causal window, learned arm", 2048, 2048, True, (256, -1), None, (0, 0), "learned", None,
     True, True),
    ("causal window, learned arm, softcap", 2048, 2048, True, (256, -1), None, (0, 0), "learned",
     SOFTCAP, True, True),
    ("8 documents, row-broadcast bias", 2048, 2048, False, None, "docs", (0, 0), "keys", None,
     True, True),
    ("8 documents, causal, full bias", 2048, 2048, True, None, "docs", (0, 0), "full", None,
     True, True),
    ("causal, q_off - kv_off = 2048", 2048, 2048, True, None, None, (2048, 0), "full", None, True,
     False),
    ("causal, q_off - kv_off = -64", 2048, 2048, True, None, None, (0, 64), "full", None, True,
     True),
    ("ragged Nq 1300, Nk 1024, window", 1300, 1024, False, (300, 300), None, (0, 0), "full", None,
     True, False)]


def _band_bias(kind: str, seed: int, B: int, Hq: int, Nq: int, Nk: int) -> torch.Tensor:
    """A BAND_CASES bias (f32) of ``kind``."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    if kind in ("mask", "learned"):
        bias = _padding_bias((Nq, int(0.45 * Nq)), Nq)
        if kind == "learned":
            bias = bias + torch.randn((1, Hq, Nq, Nk), generator=gen, device=DEVICE)
        return bias
    shape = (B, 1, 1, Nk) if kind == "keys" else (B, Hq, Nq, Nk)
    return torch.randn(shape, generator=gen, device=DEVICE)


def _band_ids(B: int, Nq: int, Nk: int):
    """8 documents a row (packed_ids) on the queries; on the keys the same,
    but document 3 renamed, so that its query rows match no key."""
    seg_q = packed_ids(B, Nq)
    seg_kv = packed_ids(B, Nk)
    return seg_q, torch.where(seg_kv == 3, 100, seg_kv)


def bias_mod(bias):
    """flex_attention's ``score_mod`` of an additive ``bias [B|1, H|1, Nq|1,
    Nk]`` on the scaled score."""
    def mod(score, b, h, q_idx, kv_idx):
        i = [x if n > 1 else 0 for x, n in zip((b, h, q_idx), bias.shape[:3])]
        return score + bias[i[0], i[1], i[2], kv_idx]
    return mod


def window_doc_mod(window=None, ids=None):
    """flex_attention's ``mask_mod`` of a window ``(left, right)`` (a
    negative bound: none) and of segment ids ``ids [B, N]``."""
    def mod(b, h, q_idx, kv_idx):
        keep = q_idx >= 0
        if window is not None and window[0] >= 0:
            keep = keep & (q_idx - kv_idx <= window[0])
        if window is not None and window[1] >= 0:
            keep = keep & (kv_idx - q_idx <= window[1])
        if ids is not None:
            keep = keep & (ids[b, q_idx] == ids[b, kv_idx])
        return keep
    return mod


def _band_library(q, k, v, do, bias, mask, *, window=None, ids=None, dbias=False) -> tuple:
    """The library yardsticks of a bias route call with a band or segment ids
    at these inputs, forward and backward: SDPA with ``attn_mask`` = the f32
    bias with the band or the documents folded in (``mask``: the pairs that
    attend; the mask value elsewhere) -- with ``dbias`` its backward takes
    the gradient of a bf16 copy of the bias, SDPA's dbias -- and
    flex_attention compiled by torch.compile with the bias as ``score_mod``
    and the band or the documents as ``mask_mod`` (flex_fwd_bwd_ms: one
    compile for both; no dbias: the bias it reads does not require grad).
    Each dict's ``library_ms`` is the faster, ``library_call`` names it."""
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE

    fold = torch.where(mask, 0.0, DEFAULT_MASK_VALUE)
    sdpa = [sdpa_ms(q, k, v, attn_mask=bias + fold)]
    if dbias:
        leaf = bias.to(torch.bfloat16).requires_grad_(True)
        sdpa.append(sdpa_ms(q, k, v, do=do, attn_mask=leaf + fold.to(torch.bfloat16),
                            bias_leaf=leaf))
        sdpa_bwd = ("scaled_dot_product_attention(attn_mask=the bias in bf16, which requires "
                    "grad, plus the folded mask) (dQ, dK, dV and dbias in one call)")
        del leaf
    else:
        sdpa.append(sdpa_ms(q, k, v, do=do, attn_mask=bias + fold))
        sdpa_bwd = "scaled_dot_product_attention(attn_mask=the f32 bias + folded mask)"
    flex = flex_fwd_bwd_ms(q, k, v, do, scale=q.shape[-1] ** -0.5, score_mod=bias_mod(bias),
                           mask_mod=window_doc_mod(window, ids))
    flex_call = (f"flex_attention (torch.compile) with the bias as score_mod and the "
                 f"{'documents' if ids is not None else 'band'} as mask_mod")
    out = []
    for what, t_sdpa, sdpa_call, t_flex in (
            ("", sdpa[0], "scaled_dot_product_attention(attn_mask=the f32 bias + folded mask)",
             flex[0]),
            ("the backward of ", sdpa[1], sdpa_bwd, flex[1])):
        best = min(((t, c) for t, c in ((t_sdpa, what + sdpa_call), (t_flex, what + flex_call))
                    if t is not None))
        out.append({"library_ms": best[0], "library_call": best[1], "sdpa_ms": t_sdpa,
                    "flex_ms": t_flex})
    return tuple(out)


def _band_timing() -> dict:
    """K1's and K5 + K6's bias routes at path A's shape (B4 H16 N2048 D128,
    bf16, q and k at GROW), each first held against its plain version
    (_fwd_bwd_check): with the window BAND_WINDOW on both arms' biases (the
    mask arm without dbias, the learned arm with), and with 8 documents a
    row (_band_ids' query ids on both sides: packed path A's) and a learned
    [1, 16, N, N] bias with dbias. Each row: its time (median CUDA-event),
    its plain version's, the library's (_band_library) and its bound over
    the pairs attended (pair_flops; the bias's bytes over those pairs too,
    dbias written whole)."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
    from flashattn_tpu_torch.utils.testing import make_qkv

    B, N = len(ATTN_LENGTHS), ATTN_SEQ
    H = ATTN_WIDTH["num_heads"]
    D = ATTN_WIDTH["qkv_features"] // H
    pad = _padding_bias(ATTN_LENGTHS, N)
    gen = torch.Generator(device=DEVICE).manual_seed(1460)
    rel = torch.randn((1, H, N, N), generator=gen, device=DEVICE)
    ids = packed_ids(B, N)
    q, k, v = _grown(1461, B, H, N, D, N, H)
    do = _bnhd(make_qkv(1462, B, H, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    stats = 4 * B * H * N
    res = {}
    for name, bias, extra, dbias in (
            ("window_mask", pad, dict(window=BAND_WINDOW), False),
            ("window_learned", pad + rel, dict(window=BAND_WINDOW), True),
            ("docs_learned", rel, dict(segment_ids=(ids, ids)), True)):
        kw = dict(scale=D ** -0.5, bias=bias, **extra)
        mask_kw = dict(kv_valid_len=N, causal=False, window=extra.get("window"),
                       segment_ids=extra.get("segment_ids"))
        keep = flash_fwd.pair_mask(N, N, device=DEVICE, **mask_kw)
        share = float(keep.expand(B, 1, N, N).float().mean())
        out = _fwd_bwd_check(f"path A's shape B{B} H{H} N{N} D{D}, {name.replace('_', ', ')} "
                             f"bias {list(bias.shape)}", q, k, v, do, phase="band",
                             want_dbias=dbias, **kw)
        args = out["args"]
        bias_bytes = tensor_bytes(bias) * share
        lib_fwd, lib_bwd = _band_library(q, k, v, do, bias, keep, window=extra.get("window"),
                                         ids=ids if "segment_ids" in extra else None,
                                         dbias=dbias)
        res[f"k1_{name}"] = {
            "max_abs_err": out["fwd_err"],
            "ms": cuda_ms(lambda: flash_fwd.fwd(q, k, v, **kw)),
            "plain_ms": cuda_ms(lambda: flash_fwd.fwd_reference(q, k, v, **kw), reps=3, trials=3),
            **bound(tensor_bytes(q, k, v, q) + bias_bytes + stats,
                    pair_flops(q, k, matmuls=2, **mask_kw)),
            **lib_fwd}
        res[f"bwd_{name}"] = {
            "max_abs_err": out["bwd_err"],
            "ms": cuda_ms(lambda: flash_bwd.bias_bwd(*args, want_dbias=dbias, **kw)),
            "plain_ms": cuda_ms(lambda: flash_bwd.bias_bwd_reference(
                *args, want_dbias=dbias, **kw), reps=2, trials=3),
            **bound(tensor_bytes(*args, q, k, v) + bias_bytes
                    + (tensor_bytes(out["dbias"]) if dbias else 0),
                    pair_flops(q, k, matmuls=5, **mask_kw)),
            **lib_bwd}
        for key in (f"k1_{name}", f"bwd_{name}"):
            r = res[key]
            log("band", f"{key} at path A's shape: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                        f"bound {r['bound_ms']:.4f} {r['bound_by']}, {share:.3f} of the pairs; "
                        f"SDPA {r['sdpa_ms']:.4f}, flex {ms_text(r['flex_ms'])}; library "
                        f"{r['library_call']})")
        del out, args, keep
        torch.cuda.empty_cache()
    return res


def phase_bias_band_check() -> dict:
    """The bias routes with a band, segment ids and q / kv offsets: K1's
    (fwd_bias_sm90_kernel, SEG with ids) and K5 + K6's (bwd_bias_sm90_kernel)
    against their plain versions on BAND_CASES at D 64 and D 128
    (_fwd_bwd_check: q and k at GROW; one launch each on its route; O, LSE,
    dQ, dK, dV and dbias within their budgets and WINDOW_REL_L2; dead rows'
    O exactly 0 and LSE exactly ln2 · mask, their dQ and dbias exactly 0;
    dbias exactly 0 on every pair the masks drop, read from NaN-filled
    memory). Then the SASS of the 12 instantiations with segment ids (HGMMA,
    UTMALDG, no HMMA) with their registers and spills, and the routes timed
    at path A's shape (_band_timing)."""
    from flashattn_tpu_torch.utils.testing import make_qkv

    B, Hq, Hkv = 2, 8, 4
    t0 = time.perf_counter()
    i = 0
    for d in (64, 128):
        for case in BAND_CASES:
            tag, nq, nk, causal, window, ids, (qo, ko), kind, cap, dbias, dead = case
            q, k, v = _grown(1470 + i, B, Hq, nq, d, nk, Hkv)
            do = _bnhd(make_qkv(1500 + i, B, Hq, nq, d, dtype=torch.bfloat16, device=DEVICE)[0])
            kw = dict(scale=d ** -0.5, causal=causal, bias=_band_bias(kind, 1530 + i, B, Hq, nq,
                                                                      nk))
            if window is not None:
                kw["window"] = window
            if ids is not None:
                kw["segment_ids"] = _band_ids(B, nq, nk)
            if (qo, ko) != (0, 0):
                kw.update(q_offset=qo, kv_offset=ko)
            if cap is not None:
                kw["softcap"] = cap
            out = _fwd_bwd_check(f"{tag}: B{B} Hq{Hq} Hkv{Hkv} Nq{nq} Nk{nk} D{d}"
                                 f"{' causal' if causal else ''}"
                                 f"{'' if window is None else f', window {window}'}"
                                 f"{'' if (qo, ko) == (0, 0) else f', offsets {(qo, ko)}'}, "
                                 f"{kind} bias {list(kw['bias'].shape)}"
                                 f"{'' if cap is None else f', softcap {cap}'}"
                                 f"{', dbias' if dbias else ''}", q, k, v, do, phase="band",
                                 want_dbias=dbias, **kw)
            if dead != bool(out["dead"]):
                fail(f"the band case {tag} at D {d} has {out['dead']} dead rows")
            del q, k, v, do, kw, out
            torch.cuda.empty_cache()
            i += 1
    log("band", f"{len(BAND_CASES)} cases at D 64 and D 128 checked in "
                f"{time.perf_counter() - t0:.1f} s")
    _tma_wgmma_sass("band", bias_route_instantiations(seg=True))
    t0 = time.perf_counter()
    res = _band_timing()
    log("band", f"timed at path A's shape in {time.perf_counter() - t0:.1f} s")
    return res


def _plain_mhdpa(m, x, bias, softcap=None):
    """The module's function written out apart from the port: the
    projections in the parameters' dtype, then softmax(q k^T · D^-1/2 + bias)
    v in f32 with the f32 ``bias`` [B|1, H, N, N] (a band or documents
    folded in at the mask value; with ``softcap`` the scaled scores capped at
    cap · tanh(s / cap) before it), cast back. A gate's reference: it shares
    no code with flash_attention_fn, the SDPA adapter or the kernels."""
    q, k, v = ((torch.einsum("bnf,fhd->bhnd", x, p.kernel) + p.bias[:, None]).float()
               for p in (m.query, m.key, m.value))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s + bias
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v).to(x.dtype)
    return torch.einsum("bhnd,hdf->bnf", o, m.out.kernel) + m.out.bias


def _path_a(arm: str, x, target, valid, mask, rel0, *, window=None, ids=None, softcap=None,
            width=None, phase: str = "bias_train") -> dict:
    """One arm of path A: FlashMultiHeadDotProductAttention (``width``,
    ATTN_WIDTH by default, bf16) on ``x`` with the key-padding ``mask`` and, where ``rel0`` is given,
    a trainable relative-position bias initialised to it (f32, passed as the
    module's ``bias``); an MSE loss over the valid rows. With ``window``
    the module is built with it (Longformer's local window; its "exact"
    impl runs the same flash_attention, so only the fused arm runs). With
    ``ids`` [B, N] (packed rows, no mask) the module's projections feed
    flash_attention(bias=the trainable bias, segment_ids=ids, layout="BNHD")
    and its output projection (the torch.nn module takes no ids, as the flax
    one takes none); fused arm only. With ``softcap`` the same projections
    feed flash_attention(bias=the mask's f32 bias, logit_softcap=softcap)
    (Gemma 2's cap with a padding bias; the module takes no cap); fused arm
    only. Loss and gradient gates: the bf16 floor
    is the plain bf16 function (_plain_mhdpa on the bf16 weights, the band
    or the documents folded into its bias) against the plain f32 one on the
    unrounded weights; the fused and exact (impl "exact", the SDPA
    adapter's oracle) arms are each held to 1.5x that floor against the f32
    one, over all gradients and, with a learned bias, over its gradient
    alone. Then LM_STEPS AdamW steps per arm (the learned bias trained with
    the weights), the launches of the fused steps counted: every K1 call
    on K1's bias route (with the window, its window variant; with the cap,
    its softcap variant; above D 128 its D 256 form), every backward one
    launch of K5 + K6's (above D 128 its D 256 form)."""
    from flashattn_tpu_torch.integrations import FlashMultiHeadDotProductAttention
    from flashattn_tpu_torch.models.transformer import adamw_init, adamw_update
    from flashattn_tpu_torch.ops import flash_fwd
    from flashattn_tpu_torch.ops.flash import flash_attention
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE

    B, N, F = x.shape
    width = ATTN_WIDTH if width is None else width
    heads, d_head = width["num_heads"], width["qkv_features"] // width["num_heads"]
    fused_only = window is not None or ids is not None or softcap is not None
    impls = ("fused",) if fused_only else ("fused", "exact")
    # The pairs that attend, folded into the plain function's bias.
    keep = flash_fwd.pair_mask(N, N, kv_valid_len=N, causal=False, window=window,
                               segment_ids=None if ids is None else (ids, ids), device=DEVICE)
    if mask is not None:
        keep = keep & mask

    def build(impl, dtype=torch.bfloat16):
        m = FlashMultiHeadDotProductAttention(
            **width, window=window, impl=impl, dtype=dtype, device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(0))
        rel = None if rel0 is None else torch.nn.Parameter(rel0.clone())
        return m, rel

    def loss_of(m, rel, plain=False):
        dtype = m.out.kernel.dtype
        if plain:
            bias = torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
            y = _plain_mhdpa(m, x.to(dtype), bias if rel is None else bias + rel, softcap)
        elif ids is not None or softcap is not None:
            q, k, v = (proj(x.to(dtype), 1) for proj in (m.query, m.key, m.value))
            bias = rel if softcap is None else torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
            y = m.out(flash_attention(q, k, v, bias=bias, segment_ids=ids, logit_softcap=softcap,
                                      layout="BNHD"), 2)
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

    models = {impl: build(impl) for impl in impls}
    n_params = sum(p.numel() for p in params_of(*models["fused"]).values())
    got = {impl: loss_and_grads(*models[impl]) for impl in impls}
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
    what = ((f"key-padding mask of lengths {ATTN_LENGTHS}" if mask is not None else
             "8 documents a row (segment ids)")
            + ("" if window is None else f", window {window}")
            + ("" if softcap is None else f", logit softcap {softcap}")
            + ("" if rel0 is None else f" + a trainable bias {list(rel0.shape)} f32"))
    log(phase, f"{arm} arm: FlashMultiHeadDotProductAttention ({n_params / 1e6:.1f} M "
               f"params, {heads} heads of {d_head}, bf16) on x [{B}, {N}, {F}], {what}: loss "
                      + ", ".join(f"{n} {got[n][0]:.7f}" for n in impls)
                      + f", plain bf16 {l16:.7f}, plain f32 {l32:.7f}; "
                      + "; ".join(f"{key} against plain f32: "
                                  + ", ".join(f"{n} {errs[n][key]:.3e}" for n in impls)
                                  + f" (limit 1.5 x bf16 floor {floors[key]:.3e}, plain bf16 "
                                    "vs plain f32)" for key in floors))
    for name, err in errs.items():
        for key, floor in floors.items():
            if not err[key] <= 1.5 * floor:
                fail(f"path A {arm} gate, {name} {only.get(key, key)}: {err[key]:.3e} against "
                     f"the plain f32 function > 1.5 x the bf16 floor {floor:.3e}")
    del got, g16, g32

    res = {}
    for name, (model, rel) in models.items():
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
        log(phase, f"{arm} arm, {name}: {LM_STEPS} AdamW steps, {step_s * 1e3:.2f} ms/step "
                          f"({', '.join(f'{s * 1e3:.1f}' for s in secs)}; median after "
                          f"{LM_WARMUP} warm-up steps), peak {res[name]['peak_gb']:.2f} GB; loss "
                          f"{losses[0]:.5f} -> {losses[-1]:.5f}")
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            fail(f"path A {arm} arm, {name} training: losses {losses} not finite or not falling")
        del params, opt
    n, dbias = LM_STEPS, (0 if rel0 is None else LM_STEPS)
    win, cap = (n if window is not None else 0), (n if softcap is not None else 0)
    wide = n if d_head > 128 else 0
    want = _expect(K1=n, K1_bias=n, K1_bias_sm90=n, K1_bias_d256=wide, K1_window=win,
                   K1_softcap=cap, bias_bwd=n, bias_bwd_dbias=dbias, bias_bwd_d256=wide)
    log(phase, f"{arm} arm, launches during the fused steps: {res['launches']} (expected "
               f"K1 = K1 bias = K1 bias sm90 = bias bwd = {n}, K1 bias d256 = bias bwd d256 = "
               f"{wide}, K1 window = {win}, K1 softcap = {cap}, bias bwd dbias = {dbias}, no K5, "
               f"K6, K3, split route or quantized K1)")
    if res["launches"] != want:
        fail(f"path A's {arm} arm launched {res['launches']}, expected {want}")
    del models
    torch.cuda.empty_cache()
    return res


def _path_a_inputs(width: dict) -> tuple:
    """Path A's inputs at ``width``: x [4, 2048, in_features], an MSE target
    at the output's own scale (its std is ~0.044 at these widths, so the loss
    moves with the attention's output and not only with the target's
    variance), the valid rows of ATTN_LENGTHS, their [B, 1, N, N] boolean
    key-padding mask (as nn.make_attention_mask builds it) and a trainable
    bias's start [1, heads, N, N], all from one seed."""
    from flashattn_tpu_torch.integrations import make_attention_mask

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    B, N, F = len(ATTN_LENGTHS), ATTN_SEQ, width["in_features"]
    x = torch.randn((B, N, F), generator=gen, device=DEVICE)
    target = 0.05 * torch.randn((B, N, F), generator=gen, device=DEVICE)
    valid = torch.arange(N, device=DEVICE)[None] < torch.tensor(ATTN_LENGTHS, device=DEVICE)[:, None]
    mask = make_attention_mask(valid, valid, dtype=torch.bool)
    rel0 = torch.randn((1, width["num_heads"], N, N), generator=gen, device=DEVICE)
    return x, target, valid, mask, rel0


def phase_bias_train() -> dict:
    """Path A: FlashMultiHeadDotProductAttention (16 heads, qkv_features
    2048, bf16, impl "fused") on x [4, 2048, 2048] with the key-padding mask of
    ATTN_LENGTHS ([B, 1, N, N] boolean, as nn.make_attention_mask builds it),
    an MSE loss over the valid rows against a random target at the output's
    scale, in two arms (_path_a): the mask alone, which needs no dbias, and
    the mask plus a trainable relative-position bias [1, 16, N, N] (a T5 /
    Swin-style learned bias), whose gradient K6's dbias gives. Then
    windowed path A, the module with Longformer's local window BAND_WINDOW,
    on both arms; and packed path A, 8 documents a row (packed_ids) with the
    trainable bias through flash_attention(bias=, segment_ids=) between the
    module's projections, over every row."""
    x, target, valid, mask, rel0 = _path_a_inputs(ATTN_WIDTH)
    B, N = x.shape[:2]
    res = {"mask": _path_a("mask", x, target, valid, mask, None),
           "learned": _path_a("learned", x, target, valid, mask, rel0)}
    res["window_mask"] = _path_a("windowed mask", x, target, valid, mask, None,
                                 window=BAND_WINDOW)
    res["window_learned"] = _path_a("windowed learned", x, target, valid, mask, rel0,
                                    window=BAND_WINDOW)
    every = torch.ones_like(valid)
    res["packed"] = _path_a("packed learned", x, target, every, None, rel0,
                            ids=packed_ids(B, N))
    return res


def phase_roofline() -> dict:
    """Path B, the roofline probes: gemm.matmul (K9) at 4096^3 and at the
    JAX test's 512 x 256 x 384 (blocks 128), and measure_mxu_peak_tflops
    (K10, size 512, 1024 iterations) -- the launches counted -- then K9's
    outputs at both shapes and at GEMM_TAIL_SHAPE against its plain version
    (bf16 out: FWD_TOL[bf16]; f32 out: FWD_TOL[f32] at the small shapes, the
    f32 summation bound K·2^-24·(|A||B|) at 4096^3) and K10 against its
    plain version at size 256, 4 iterations (FWD_TOL[bf16]); the HMMA
    instructions of K10's SASS (at least 2 x N_CHAINS: its chains' products
    are neither merged nor hoisted), K9's HGMMA (wgmma) and no HMMA, and the
    measured mma.sync peak at most the datasheet's 989 TFLOP/s; the chained
    torch.matmul peak beside it. Times K9 and K10 beside their plain versions
    and torch.matmul, and prints K9's TFLOP/s beside K10's and
    torch.matmul's."""
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
    m, n, kd = GEMM_TAIL_SHAPE
    operands.append(tuple(torch.randn(sh, generator=gen, device=DEVICE).to(torch.bfloat16)
                          for sh in ((m, kd), (kd, n))))
    outs.append(gemm.matmul(*operands[-1], block_m=128, block_n=128, block_k=128))
    for (m, n, kd), (a, b), out in zip((*GEMM_SHAPES, GEMM_TAIL_SHAPE), operands, outs):
        want = gemm.matmul_reference(a, b, torch.float32)
        ok, msg = check_close(out, want, FWD_TOL[torch.bfloat16], "K9 bf16")
        err = (out.float() - want).abs().max().item()
        out32 = gemm.matmul(a, b, block_m=128, block_n=128, block_k=128, out_dtype=torch.float32)
        if kd <= 512:
            ok32, msg32 = check_close(out32, want, FWD_TOL[torch.float32], "K9 f32")
            budget = "FWD_TOL[f32]"
        else:
            # Summation in another order: within the forward error bound of a
            # K-term f32 sum, K·2^-24·(|A||B|) per element.
            bound32 = kd * 2.0 ** -24 * gemm.matmul_reference(a.abs(), b.abs(), torch.float32)
            excess = ((out32 - want).abs() - bound32).max().item()
            ok32, msg32 = excess <= 0, f"K9 f32: |err| - K 2^-24 (|A||B|) max {excess:.3e}"
            budget = "K 2^-24 (|A||B|) per element"
        log("roofline", f"K9 {m}x{kd} @ {kd}x{n} bf16: bf16 out max_abs_err {err:.3e} "
                        f"(FWD_TOL[bf16], max|ref| {want.abs().max().item():.2f}); f32 out "
                        f"max_abs_err {(out32 - want).abs().max().item():.3e} ({budget})")
        if not (ok and ok32):
            fail(f"K9 disagrees with its plain version at {m}x{kd}x{n}: {msg}; {msg32}")
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

    k9_names = ("K9 gemm_wgmma_kernel<0>", "K9 gemm_wgmma_kernel<1>")
    names = {"K10 roofline_kernel<4>", *k9_names}
    sass = sass_opcodes(native.BUILD_DIR / native.LIB_NAME, names)
    mma = {name: {op: sass.get(name, collections.Counter())[op] for op in ("HMMA", "HGMMA")}
           for name in sorted(names)}
    log("roofline", f"HMMA / HGMMA instructions in the SASS: {mma} (K10 needs at least "
                    f"{2 * roofline.N_CHAINS} HMMA: {roofline.N_CHAINS} chains x 2 n-tiles per "
                    "k-step; K9 HGMMA and no HMMA)")
    if mma["K10 roofline_kernel<4>"]["HMMA"] < 2 * roofline.N_CHAINS:
        fail(f"K10's SASS has {mma['K10 roofline_kernel<4>']['HMMA']} HMMA: its products were "
             "merged")
    for name in k9_names:
        if mma[name]["HGMMA"] == 0 or mma[name]["HMMA"] != 0:
            fail(f"{name}'s SASS has {mma[name]}: K9 must run on wgmma (HGMMA) alone")
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
    flops = 2.0 * m * n * kd
    log("roofline", f"K9 at {m}x{kd} @ {kd}x{n}: {flops / res['k9']['ms'] / 1e9:.1f} TFLOP/s "
                    f"(torch.matmul {flops / res['k9']['library_ms'] / 1e9:.1f}), beside K10's "
                    f"mma.sync {mxu:.1f} and the chained torch.matmul {matmul_peak:.1f} TFLOP/s")
    return res


# K9's and K10's f32 forms (phase_roofline_f32): K9 at GEMM_SHAPES and
# GEMM_TAIL_SHAPE, K10 at ROOFLINE_SIZE x ROOFLINE_ITERS (its f32 panels
# fill shared memory at 512), the chained f32 torch.matmul at
# MATMUL_F32_PEAK_SIZE.
MATMUL_F32_PEAK_SIZE = 2048


def phase_roofline_f32() -> dict:
    """The probes' f32 forms: K9 on f32 a, b (the split of a and b, then six
    bf16 products per f32 product on wgmma) against torch.matmul with TF32
    off -- FWD_TOL[f32] at 512x256x384 and 512x384x256 in f32 and bf16 out
    (bf16 out: FWD_TOL[bf16]), within the f32 summation bound K 2^-24
    (|A||B|) at 4096^3 -- and K10's f32 form (panels split once, six bf16
    mma.sync per f32 product) against roofline_reference at size 256, 4
    iterations (within the f32 summation bound of its terms); launches
    exact (the driving run: K9 f32 and its split twice, K10 f32 > 0); the
    SASS: K9 f32 HGMMA and no HMMA, K10
    f32 at least 6 x 2 x N_CHAINS HMMA. Measures K10's f32-accurate rate and
    the chained f32 torch.matmul's beside PEAK_F32_ACCURATE_FLOPS (165
    TFLOP/s, the bound of every f32 row), and times K9 at 4096^3 and K10
    beside their plain versions, bounds and library calls."""
    from flashattn_tpu_torch.ops import gemm, roofline
    from flashattn_tpu_torch.ops.oracle import _full_f32_matmul
    from flashattn_tpu_torch.utils import native
    from flashattn_tpu_torch.utils.testing import FWD_TOL, check_close

    _f32_tf32_off()
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    shapes = (*GEMM_SHAPES, GEMM_TAIL_SHAPE)
    operands = [tuple(torch.randn(s, generator=gen, device=DEVICE) for s in ((m, kd), (kd, n)))
                for m, n, kd in shapes]
    _reset_launches()
    big = gemm.matmul(*operands[0])
    small = gemm.matmul(*operands[1], block_m=128, block_n=128, block_k=128)
    size, iters = ROOFLINE_SIZE, ROOFLINE_ITERS
    peak = roofline.measure_mxu_peak_tflops(size=size, iters=iters, dtype=torch.float32)
    counts = _launches()
    log("roofline f32", f"launches driving the f32 probes: "
                        f"{ {x: c for x, c in counts.items() if c} } (expected K9 = K9 f32 = "
                        "split bf16x3 = 2, K10 = K10 f32 > 0, no other)")
    if (counts != _expect(K9=2, K9_f32=2, split_bf16x3=2, K10=counts["K10"],
                          K10_f32=counts["K10"]) or not counts["K10"]):
        fail(f"the f32 probes launched {counts}")
    res = {"launches": counts, "k10_tflops": peak}
    for (m, n, kd), (a, b), out in zip(shapes, operands, (big, small, None)):
        want = gemm.matmul_reference(a, b)  # full f32, TF32 off
        for out_dtype in (torch.float32, torch.bfloat16):
            if out is None or out_dtype == torch.bfloat16:
                out = gemm.matmul(a, b, block_m=128, block_n=128, block_k=128,
                                  out_dtype=out_dtype)
            err = (out.float() - want).abs().max().item()
            if out_dtype == torch.bfloat16:
                ok, msg = check_close(out, want, FWD_TOL[torch.bfloat16], "K9 f32, bf16 out")
                budget = "FWD_TOL[bf16]"
            elif kd <= 512:
                ok, msg = check_close(out, want, FWD_TOL[torch.float32], "K9 f32")
                budget = "FWD_TOL[f32]"
            else:
                bound32 = kd * 2.0 ** -24 * gemm.matmul_reference(a.abs(), b.abs())
                excess = ((out - want).abs() - bound32).max().item()
                ok, msg = excess <= 0, f"K9 f32: |err| - K 2^-24 (|A||B|) max {excess:.3e}"
                budget = "K 2^-24 (|A||B|) per element"
            log("roofline f32", f"K9 f32 {m}x{kd} @ {kd}x{n}, {str(out_dtype)[6:]} out: "
                                f"max_abs_err {err:.3e} ({budget}, max|ref| "
                                f"{want.abs().max().item():.2f})")
            if not ok or out.dtype != out_dtype:
                fail(f"K9's f32 form disagrees with torch.matmul at {m}x{kd}x{n}: {msg}")
            if (m, n, kd) == GEMM_SHAPES[0] and out_dtype == torch.float32:
                k9_err = err
            out = None
    # K10: N_CHAINS sums of 256 products, added: within the f32 summation
    # bound of its N_CHAINS (256 + N_CHAINS) terms per element (an element
    # whose terms cancel leaves no room for FWD_TOL[f32]'s rtol: 2.6e-4 off
    # at |e| 0.23 in the first run, where the bound allowed 1.7e-3).
    a, b = (torch.randn((256, 256), generator=gen, device=DEVICE) for _ in range(2))
    out = roofline.roofline_call(a, b, iters=4, size=256)
    want = roofline.roofline_reference(a, b, iters=4)
    bound10 = (roofline.N_CHAINS * (256 + roofline.N_CHAINS) * 2.0 ** -24
               * gemm.matmul_reference(a.abs(), b.abs()))
    excess = ((out - want).abs() - bound10).max().item()
    k10_err = (out - want).abs().max().item()
    log("roofline f32", f"K10 f32 size 256, 4 iterations: max_abs_err {k10_err:.3e} (f32 "
                        f"summation bound N_CHAINS (256 + N_CHAINS) 2^-24 (|A||B|): |err| - "
                        f"bound max {excess:.3e}; max|ref| {want.abs().max().item():.2f})")
    if not excess <= 0 or out.dtype != torch.float32:
        fail(f"K10's f32 form disagrees with its plain version: |err| - bound max {excess:.3e}")

    k9_names = {"K9 f32 gemm_f32_kernel<0>", "K9 f32 gemm_f32_kernel<1>"}
    k10_name = f"K10 f32 roofline_kernel<{roofline.N_CHAINS}, float>"
    sass = sass_opcodes(native.BUILD_DIR / native.LIB_NAME, k9_names | {k10_name})
    mma = {x: {op: sass.get(x, collections.Counter())[op] for op in ("HMMA", "HGMMA")}
           for x in sorted(k9_names | {k10_name})}
    log("roofline f32", f"HMMA / HGMMA instructions in the SASS: {mma} (K10 f32 needs at least "
                        f"{6 * 2 * roofline.N_CHAINS}: six products x {roofline.N_CHAINS} chains "
                        "x 2 n-tiles a k-step; K9 f32 HGMMA and no HMMA); registers, stack, "
                        "spill stores / loads: "
                        + ", ".join(f"{x} {BUILD_STATS.get(x)}" for x in sorted(mma)))
    if mma[k10_name]["HMMA"] < 6 * 2 * roofline.N_CHAINS:
        fail(f"K10 f32's SASS has {mma[k10_name]['HMMA']} HMMA: its products were merged")
    for x in k9_names:
        if mma[x]["HGMMA"] == 0 or mma[x]["HMMA"] != 0:
            fail(f"{x}'s SASS has {mma[x]}: K9's f32 form must run on wgmma (HGMMA) alone")
    matmul_peak = roofline.measure_xla_matmul_peak_tflops(size=MATMUL_F32_PEAK_SIZE,
                                                          dtype=torch.float32)
    res["matmul_tflops"] = matmul_peak
    accurate = PEAK_F32_ACCURATE_FLOPS / 1e12
    log("roofline f32", f"measured f32 rates: K10's f32 form (six bf16 mma.sync per f32 "
                        f"product, size {size}, {iters} iterations, {roofline.N_CHAINS} chains) "
                        f"{peak:.1f} TFLOP/s, {peak / accurate:.1%} of the {accurate:.0f} TFLOP/s "
                        f"that the f32 rows' bounds assume; chained f32 torch.matmul (TF32 off, "
                        f"size {MATMUL_F32_PEAK_SIZE}) {matmul_peak:.1f} TFLOP/s")
    if not 0 < peak <= accurate:
        fail(f"K10 f32 measured {peak:.1f} TFLOP/s, outside (0, {accurate:.0f}]")

    a, b = operands[0]
    m, n, kd = GEMM_SHAPES[0]
    with _full_f32_matmul():
        lib = cuda_ms(lambda: torch.matmul(a, b))
    res["k9"] = {"max_abs_err": k9_err, "ms": cuda_ms(lambda: gemm.matmul(a, b)),
                 "kernel_ms": kernels_ms(lambda: gemm.matmul(a, b)),
                 "plain_ms": cuda_ms(lambda: gemm.matmul_reference(a, b), reps=3, trials=3),
                 **bound(tensor_bytes(a, b, big), 2.0 * m * n * kd, PEAK_F32_ACCURATE_FLOPS),
                 "library_ms": lib, "library_call": "torch.matmul (f32, TF32 off)"}
    a, b = (torch.randn((size, size), generator=gen, device=DEVICE) for _ in range(2))
    a4, b4 = (x.expand(roofline.N_CHAINS, size, size).contiguous() for x in (a, b))
    c0 = torch.zeros((roofline.N_CHAINS, size, size), device=DEVICE)

    def chained_matmul():
        c = c0
        for _ in range(iters):
            c = torch.baddbmm(c, a4, b4, beta=1e-30)
        return c

    with _full_f32_matmul():
        lib = cuda_ms(chained_matmul, reps=1, trials=3)
    res["k10"] = {"max_abs_err": k10_err,
                  "ms": cuda_ms(lambda: roofline.roofline_call(a, b, iters=iters, size=size),
                                reps=3, trials=3),
                  "plain_ms": cuda_ms(lambda: roofline.roofline_reference(a, b, iters=iters),
                                      reps=1, trials=3),
                  **bound(3 * size * size * 4, 2.0 * size ** 3 * iters * roofline.N_CHAINS,
                          PEAK_F32_ACCURATE_FLOPS),
                  "library_ms": lib,
                  "library_call": (f"{iters} chained torch.baddbmm of [{roofline.N_CHAINS}, "
                                   f"{size}, {size}] f32, TF32 off (beta 1e-30)")}
    flops = 2.0 * m * n * kd
    for key, r in (("K9 f32", res["k9"]), ("K10 f32", res["k10"])):
        log("roofline f32", f"{key}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['library_call']} "
                            f"{r['library_ms']:.4f} ms")
    log("roofline f32", f"K9 f32 at {m}x{kd} @ {kd}x{n}: {flops / res['k9']['ms'] / 1e9:.1f} "
                        f"f32-accurate TFLOP/s (split included; kernels alone "
                        f"{flops / res['k9']['kernel_ms'] / 1e9:.1f}), torch.matmul f32 "
                        f"{flops / res['k9']['library_ms'] / 1e9:.1f}, beside K10 f32's {peak:.1f} "
                        f"and {accurate:.0f} TFLOP/s ({_card_name()}; {_card_state()})")
    return res


# Ring attention (parallel/ring_kernel.py): context-parallel long-context
# training at the LM's attention width (bench_lm.py:122-125: Hq16 Hkv8 D128,
# bf16, B1), the global sequence split over RING_RANKS virtual ranks of
# RING_CHUNK tokens. (name, ranks, chunk, Hq, Hkv, D, causal, window, GROW,
# expected K7 = K8 launches): the main shape causal and with a 2048-token
# window (q, k at GROW x unit scale: a pair missed at a band edge moves an
# output by O(1)), non-causal, 8 ranks with GQA 16/2 (the JAX package's slow
# 8-device case), one rank, which must give what K1 / K3 give, and two small
# windowed cases at D 64 and D 96 (q, k at GROW): a band edge of 127 inside
# every 128-row tile, and a head dim whose second 64-column TMA box the
# kernels fill with zeros.
RING_RANKS, RING_CHUNK = 4, 4096
RING_WINDOW = (2048, -1)
RING_CASES = [("causal", 4, 4096, 16, 8, 128, True, None, 1, 10),
              ("window", 4, 4096, 16, 8, 128, True, RING_WINDOW, GROW, 7),
              ("non-causal", 4, 1024, 16, 8, 128, False, None, 1, 16),
              ("8 ranks GQA 16/2", 8, 1024, 16, 2, 128, True, None, 1, 36),
              ("1 rank", 1, 4096, 16, 8, 128, True, None, 1, 1),
              ("D64 window edge", 2, 512, 4, 2, 64, True, (127, -1), GROW, 3),
              ("D96 window edge", 2, 512, 4, 2, 96, True, (127, -1), GROW, 3)]
# The ring kernels' f32 and D 136-256 forms (phase_ring_wide), as RING_CASES
# with the dtype first: the f32 LM's attention (Hq16 Hkv8 D128, f32) causal
# and windowed, Gemma 2's heads of 256 (Hq8 Hkv4 D256) in bf16 causal and
# windowed and in f32 causal, at RING_RANKS x RING_CHUNK; then small cases: a
# band edge inside every 128-row tile at D 136 (GQA 4/1, a second 128-column
# half of 8 real columns) in both dtypes and at D 64 in f32 (the f32 D 64
# instantiations), D 100 (padded to 104 by the entry point) non-causal, 8
# ranks with GQA 16/2, and one rank in f32 at D 256, which must give what
# K1's and K3's f32 D 256 forms give.
F32 = torch.float32
BF16 = torch.bfloat16
RING_WIDE_CASES = [("f32 causal", F32, 4, 4096, 16, 8, 128, True, None, 1, 10),
                   ("f32 window", F32, 4, 4096, 16, 8, 128, True, RING_WINDOW, GROW, 7),
                   ("bf16 D256 causal", BF16, 4, 4096, 8, 4, 256, True, None, 1, 10),
                   ("bf16 D256 window", BF16, 4, 4096, 8, 4, 256, True, RING_WINDOW, GROW, 7),
                   ("f32 D256 causal", F32, 4, 4096, 8, 4, 256, True, None, 1, 10),
                   ("bf16 D136 window edge", BF16, 2, 512, 4, 1, 136, True, (127, -1), GROW, 3),
                   ("f32 D136 window edge", F32, 2, 512, 4, 1, 136, True, (127, -1), GROW, 3),
                   ("f32 D64 window edge", F32, 2, 512, 4, 2, 64, True, (127, -1), GROW, 3),
                   ("f32 D100 non-causal", F32, 2, 512, 4, 2, 100, False, None, 1, 4),
                   ("f32 8 ranks GQA 16/2", F32, 8, 1024, 16, 2, 128, True, None, 1, 36),
                   # K8 f32's group walk with an odd count of visits: 3 query
                   # heads a KV head x 3 Q tiles a KV tile on the diagonal
                   # step, x 1 on the off-diagonal one.
                   ("f32 GQA 3/1 window (31, -1)", F32, 2, 512, 3, 1, 128, True, (31, -1),
                    GROW, 3),
                   ("f32 D256 GQA 3/1 window (31, -1)", F32, 2, 512, 3, 1, 256, True, (31, -1),
                    GROW, 3),
                   ("f32 D256 1 rank", F32, 1, 4096, 8, 4, 256, True, None, 1, 1)]
# The forms the wide cases time at RING_RANKS x RING_CHUNK causal (the first
# case of each), by the name of their `kernels` entries.
RING_WIDE_TIMED = {"f32 causal": "f32", "bf16 D256 causal": "bf16 D 256",
                   "f32 D256 causal": "f32 D 256"}
# One direction of the H100 SXM's NVLink (the hopper guide's table).
NVLINK_BYTES_PER_S = 450e9


def _ring_inputs(seed: int, ranks: int, chunk: int, hq: int, hkv: int, d: int, grow: int,
                 dtype=torch.bfloat16):
    """q, k (x grow), v and dO, [1, H, ranks * chunk, d] in ``dtype``."""
    from flashattn_tpu_torch.utils.testing import make_qkv

    n = ranks * chunk
    q, k, v = make_qkv(seed, 1, hq, n, d, Hkv=hkv, device=DEVICE)
    do = make_qkv(seed + 1, 1, hq, n, d, device=DEVICE)[0]
    return tuple(x.to(dtype) for x in (grow * q, grow * k, v, do))


def _ring_gate(tag: str, got: dict, want: dict, what: str,
               dtype=torch.bfloat16) -> tuple[float, float]:
    """O within FWD_TOL[dtype], the LSE within LSE_ATOL (bf16) or
    FWD_TOL[f32], dQ/dK/dV within BWD_TOL[dtype], each also within relative
    L2 WINDOW_REL_L2; logs and fails. Returns the max errors of O and of the
    gradients."""
    from flashattn_tpu_torch.utils.testing import (
        BWD_TOL, FWD_TOL, Tolerance, check_close, grad_gate)

    name = "f32" if dtype == torch.float32 else "bf16"
    lse_tol = FWD_TOL[torch.float32] if dtype == torch.float32 else Tolerance(LSE_ATOL, 0.0)
    ok_o, msg_o = check_close(got["o"], want["o"], FWD_TOL[dtype], "O")
    ok_l, msg_l = check_close(got["lse"], want["lse"], lse_tol, "LSE")
    names = ("dq", "dk", "dv")
    ok_g, why, err_g, _ = grad_gate([got[n] for n in names], [want[n] for n in names],
                                    BWD_TOL[dtype], names=names)
    err_o = (got["o"].float() - want["o"].float()).abs().max().item()
    rel = {n: _rel(got[n].float(), want[n].float()) for n in ("o", *names)}
    log("ring", f"{tag} vs {what}: O max_abs_err {err_o:.3e} (budget FWD_TOL[{name}]), LSE "
                f"max_abs_err {(got['lse'] - want['lse']).abs().max().item():.3e} (budget "
                f"{tuple(lse_tol)}), dQ/dK/dV max_abs_err {err_g:.3e} (budget BWD_TOL[{name}]); "
                f"relative L2 (limit {WINDOW_REL_L2}): "
                + ", ".join(f"{n} {r:.2e}" for n, r in rel.items()))
    if not (ok_o and ok_l and ok_g):
        fail(f"the ring disagrees with {what} at {tag}: {msg_o}; {msg_l}; {why}")
    if not all(r <= WINDOW_REL_L2 for r in rel.values()):
        fail(f"relative L2 error above {WINDOW_REL_L2} against {what} at {tag}: {rel}")
    return err_o, err_g


def _ring_bytes(ranks: int, chunk: int, hq: int, hkv: int, d: int, elem: int, causal: bool,
                window) -> tuple:
    """Bytes each live step must move, summed over the ring, for head dim
    ``d`` and Q / K / V / O / dO of ``elem`` bytes an element: K7 reads its Q
    chunk and K/V chunk and the f32 running state (acc, m, l) except on a
    rank's first live step, and writes the state or, on the last, O and LSE;
    K8 reads Q, dO, K, V, LSE and Delta, reads and writes the f32 dK/dV
    accumulators and the f32 dQ."""
    from flashattn_tpu_torch.parallel.ring_kernel import _live_steps

    q_b, kv_b = elem * hq * chunk * d, elem * 2 * hkv * chunk * d
    state_b, stats_b = 4 * hq * chunk * (d + 2), 4 * hq * chunk
    dkv_b, dq_b = 4 * 2 * hkv * chunk * d, 4 * hq * chunk * d
    fwd = bwd = 0
    for steps in (_live_steps(r, ranks, chunk, chunk, causal, window) for r in range(ranks)):
        for s in steps:
            fwd += q_b + kv_b + (0 if s == steps[0] else state_b)
            fwd += q_b + stats_b if s == steps[-1] else state_b
            bwd += 2 * q_b + kv_b + 2 * stats_b + 2 * dkv_b + 2 * dq_b
    return fwd, bwd


def _ring_expect(dtype, d: int, n: int) -> dict:
    """The launch counts of a ring with ``n`` live (rank, step) pairs: K7 =
    K8 = n, on the f32 forms (and one split bf16x3 each) for f32 and on the
    D 256 forms above D 128."""
    f32, wide = int(dtype == torch.float32), int(d + -d % 8 > 128)
    return _expect(K7=n, K8=n, K7_f32=n * f32, K8_f32=n * f32, K7_d256=n * wide,
                   K8_d256=n * wide, split_bf16x3=2 * n * f32)


def _ring_case(i: int, case, dtype, phase: str) -> dict:
    """One ring case (RING_CASES' fields after the dtype): the forward and the
    gradients through ring_attention_kernel_sharded with autograd and exact
    launch counts (_ring_expect, the counters reset just before), held
    against the plain ring (run_virtual_ring(plain=True), TF32 off) and
    against single-device K1 / K3 on the global sequence, fed the ring's
    pre-scaled q2 with scale ln2 (the same scores: the rounding of q2 stays
    out of the gate) and the head dim zero-padded to a multiple of 8 as the
    ring pads it. Returns the errors, counts, inputs and outputs."""
    from flashattn_tpu_torch.ops import flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.parallel import ring_attention_kernel_sharded
    from flashattn_tpu_torch.parallel import ring_kernel as rk

    name, ranks, chunk, hq, hkv, d, causal, window, grow, expect = case
    q, k, v, do = _ring_inputs(1400 + 10 * i + (dtype == torch.float32), ranks, chunk, hq, hkv,
                               d, grow, dtype)
    tag = (f"{name}: {ranks} ranks x {chunk} B1 Hq{hq} Hkv{hkv} D{d} "
           f"{'f32' if dtype == torch.float32 else 'bf16'} "
           f"{'causal' if causal else 'non-causal'}"
           f"{'' if window is None else f' window {window}'}"
           f"{'' if grow == 1 else f' (q, k x{grow})'}")
    kw = dict(causal=causal, window=window)
    ring = ring_attention_kernel_sharded(ranks=ranks, **kw)
    leaves = tuple(x.detach().requires_grad_(True) for x in (q, k, v))
    _reset_launches()
    o = ring(*leaves)
    dq, dk, dv = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    counts = _launches()
    want_counts = _ring_expect(dtype, d, expect)
    log(phase, f"{tag}: launches {counts} (expected "
               f"{ {n: c for n, c in want_counts.items() if c} }, no other)")
    if counts != want_counts:
        fail(f"the ring at {tag} launched {counts}, expected {want_counts}")
    got = {"o": o.detach(), "lse": rk.run_virtual_ring(q, k, v, ranks=ranks, **kw)[1],
           "dq": dq, "dk": dk, "dv": dv}
    plain = dict(zip(("o", "lse", "dq", "dk", "dv"), rk.run_virtual_ring(
        q, k, v, do, ranks=ranks, plain=True, **kw)))
    err = _ring_gate(tag, got, plain, "the plain ring", dtype)
    # dL/dq = dL/dq2 · scale·log2e.
    q2, s2q = rk._prescale(q, d ** -0.5), d ** -0.5 * rk.LOG2E
    q2p, kp, vp, dop = rk._pad_d(q2, k, v, do)
    o1, lse1 = flash_fwd.fwd(q2p, kp, vp, scale=rk.LN2, **kw)
    delta = (dop.float() * o1.float()).sum(-1)
    g3 = flash_bwd_fused.bwd(q2p, kp, vp, dop, lse1, delta, scale=rk.LN2, **kw)
    single = {"o": o1[..., :d], "lse": lse1, "dq": g3[0][..., :d] * s2q,
              **{n: g[..., :d].reshape(1, hkv, g.shape[1] // hkv, *g.shape[2:-1], d).sum(2)
                 for n, g in zip(("dk", "dv"), g3[1:])}}
    _ring_gate(tag, got, single, "single-device K1 / K3", dtype)
    out = {"err": err, "counts": counts, "inputs": (q, k, v, do), "kw": kw, "got": got}
    del o, dq, dk, dv, plain, single, g3, o1, q2, leaves
    torch.cuda.empty_cache()
    return out


def _nccl_one_rank(inputs, want: dict, limit: float, phase: str) -> None:
    """A one-rank NCCL process group (world size 1, an in-process store)
    through ring_attention_kernel(group=), causal, against the one virtual
    rank's outputs ``want`` within ``limit`` (dQ's bulk reductions add in a
    varying order)."""
    import torch.distributed as dist

    from flashattn_tpu_torch.parallel import ring_attention_kernel

    q, k, v, do = inputs
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        leaves = tuple(x.detach().requires_grad_(True) for x in (q, k, v))
        o = ring_attention_kernel(*leaves, group=dist.group.WORLD, causal=True)
        grads = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    diffs = [(a.float() - want[n].float()).abs().max().item()
             for n, a in zip(("o", "dq", "dk", "dv"), (o, *grads))]
    log(phase, f"one-rank NCCL group (world size 1, {q.dtype}, D{q.shape[-1]}) vs the one "
               f"virtual rank: O / dQ / dK / dV max_abs_diff "
               f"{', '.join(f'{d:.3e}' for d in diffs)} (limit {limit})")
    if not max(diffs) <= limit:
        fail(f"the one-rank NCCL ring differs from the virtual rank: {diffs}")


def _ring_timing(inputs, err, *, label: str, phase: str,
                 window_inputs=None) -> tuple[dict, dict]:
    """Times of the ring at RING_RANKS x RING_CHUNK causal on ``inputs``
    (bf16 or f32): the whole ring forward and backward, each with its
    TFLOP/s, the plain ring, single-device K1 / K3 and SDPA at the global
    shape (bf16: its own choice of backend; f32: the memory-efficient
    backend on K / V expanded to the query heads, TF32 off -- the math
    backend's f32 scores would not fit), K7 and K8 per step (rank 0's
    diagonal chunk, its first step, and rank 1's full off-diagonal chunk at
    step 1, read, merged and written; an f32 step's time includes its
    split), and the bytes one rotation would put on NVLink; with
    ``window_inputs``, the ring with RING_WINDOW on them. Returns the
    `kernels` entries' numbers of K7 and K8 (``err`` their max errors)."""
    from torch.nn.attention import SDPBackend

    from flashattn_tpu_torch.ops import flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.parallel import ring_attention_kernel_sharded
    from flashattn_tpu_torch.parallel import ring_kernel as rk

    q, k, v, do = inputs
    f32_in = q.dtype == torch.float32
    n, d = q.shape[2], q.shape[3]
    scale, hq, hkv, elem = d ** -0.5, q.shape[1], k.shape[1], q.element_size()
    ring = ring_attention_kernel_sharded(ranks=RING_RANKS, causal=True)
    leaves = tuple(x.detach().requires_grad_(True) for x in (q, k, v))
    out = ring(*leaves)
    fwd_ms = cuda_ms(lambda: ring(q, k, v), reps=5, trials=3)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), reps=3,
                     trials=3)
    xport = rk.VirtualRanks(RING_RANKS)
    q2 = rk._prescale(q, scale)
    o_ref, lse_ref = rk.run_virtual_ring(q, k, v, ranks=RING_RANKS, causal=True)
    lses = [x.contiguous() for x in xport.split(lse_ref)]
    plain_fwd_ms = cuda_ms(lambda: rk.run_virtual_ring(q, k, v, ranks=RING_RANKS, causal=True,
                                                       plain=True), reps=1, trials=3)
    plain_bwd_ms = cuda_ms(lambda: rk._ring_grads(
        xport, q2, k, v, o_ref, lses, do, scale=scale, causal=True, window=None,
        step=rk.ring_bwd_step_reference), reps=1, trials=3)
    k1_ms = cuda_ms(lambda: flash_fwd.fwd(q, k, v, scale=scale, causal=True), reps=5, trials=3)
    o1, lse1 = flash_fwd.fwd(q, k, v, scale=scale, causal=True)
    delta = (do.float() * o1.float()).sum(-1)
    k3_ms = cuda_ms(lambda: flash_bwd_fused.bwd(q, k, v, do, lse1, delta, scale=scale,
                                                causal=True), reps=3, trials=3)
    del o1
    if f32_in:
        kx, vx = (x.repeat_interleave(hq // hkv, 1) for x in (k, v))
        try:
            lib = [sdpa_ms(q, kx, vx, do=g, is_causal=True,
                           backend=SDPBackend.EFFICIENT_ATTENTION) for g in (None, do)]
        except RuntimeError as e:  # the backend refused these inputs
            log(phase, f"SDPA's memory-efficient backend refused f32 D{d}: {str(e)[:200]}")
            lib = [None, None]
        del kx, vx
        lib_call = (f"scaled_dot_product_attention(is_causal=True), memory-efficient backend, "
                    f"f32 with TF32 off, K / V expanded to the query heads, on the global "
                    f"[1, {hq}, {n}, {d}]")
    else:
        lib = [sdpa_ms(q, k, v, do=g, is_causal=True) for g in (None, do)]
        lib_call = (f"scaled_dot_product_attention(is_causal=True, enable_gqa=True), its own "
                    f"choice of backend, on the global [1, {hq}, {n}, {d}]")

    c = RING_CHUNK
    qs, ks, vs, dos = (xport.split(x) for x in (q2, k, v, do))
    f32 = dict(dtype=torch.float32, device=DEVICE)
    acc, m, l = (torch.empty((1, hq, c, d), **f32), torch.empty((1, hq, c), **f32),
                 torch.empty((1, hq, c), **f32))
    o_c, lse_c = torch.empty_like(qs[0]), torch.empty((1, hq, c), **f32)
    deltas = [x.contiguous() for x in xport.split((do.float() * o_ref.float()).sum(-1))]
    dq_c, dk_c, dv_c = (torch.zeros((1, hq, c, d), **f32), torch.zeros((1, hkv, c, d), **f32),
                        torch.zeros((1, hkv, c, d), **f32))
    steps = {"diagonal": dict(rank=0, src=0, first=True),
             "off-diagonal": dict(rank=1, src=0, first=False)}
    step_ms = {}
    for key, st in steps.items():
        r, src = st["rank"], st["src"]
        pos = dict(q_base=r * c, kv_off=src * c, causal=True)
        step_ms[key] = (
            cuda_ms(lambda: rk.ring_fwd_step(qs[r], ks[src], vs[src], acc, m, l, o_c, lse_c,
                                             first=st["first"], **pos), reps=10, trials=3),
            cuda_ms(lambda: rk.ring_bwd_step(qs[r], ks[src], vs[src], dos[r], lses[r], deltas[r],
                                             dq_c, dk_c, dv_c, **pos), reps=5, trials=3))
    pair = dict(kv_valid_len=n, causal=True, segment_ids=None)
    peak = PEAK_F32_ACCURATE_FLOPS if f32_in else PEAK_BF16_FLOPS
    fwd_bytes, bwd_bytes = _ring_bytes(RING_RANKS, c, hq, hkv, d, elem, True, None)
    fwd_flops, bwd_flops = pair_flops(q, k, matmuls=2, **pair), pair_flops(q, k, matmuls=5, **pair)
    k7 = {"max_abs_err": err[0], "ms": fwd_ms, "plain_ms": plain_fwd_ms,
          **bound(fwd_bytes, fwd_flops, peak), "library_ms": lib[0], "library_call": lib_call}
    k8 = {"max_abs_err": err[1], "ms": bwd_ms, "plain_ms": plain_bwd_ms,
          **bound(bwd_bytes, bwd_flops, peak), "library_ms": lib[1],
          "library_call": f"the backward of {lib_call}"}
    lib_txt = " / ".join("refused" if t is None else f"{t:.4f}" for t in lib)
    log(phase, f"{label}: {RING_RANKS} ranks x {c} B1 Hq{hq} Hkv{hkv} D{d} causal: forward ring "
               f"{fwd_ms:.4f} ms ({fwd_flops / fwd_ms / 1e9:.1f} TFLOP/s), backward ring "
               f"{bwd_ms:.4f} ms ({bwd_flops / bwd_ms / 1e9:.1f} TFLOP/s); plain ring "
               f"{plain_fwd_ms:.2f} / {plain_bwd_ms:.2f} ms; single-device K1 {k1_ms:.4f} ms, "
               f"K3 {k3_ms:.4f} ms at N{n}; SDPA {lib_txt} ms; bound {k7['bound_ms']:.4f} "
               f"({k7['bound_by']}) / {k8['bound_ms']:.4f} ms ({k8['bound_by']}) "
               f"(median CUDA-event time)")
    products = 6 if f32_in else 1  # bf16 products per product
    for key, (f_ms, b_ms) in step_ms.items():
        f_fl, b_fl = (products * ring_step_flops(hq, c, d, diagonal=key == "diagonal", matmuls=n)
                      for n in (2, 5))
        log(phase, f"{label}: one step, {key} {c} x {c} chunk pair: K7 {f_ms:.4f} ms "
                   f"({f_fl / f_ms / 1e9:.1f} TFLOP/s), K8 {b_ms:.4f} ms "
                   f"({b_fl / b_ms / 1e9:.1f} TFLOP/s)"
                   + (" (bf16 TFLOP/s: six bf16 products per f32 product)" if f32_in else ""))
    kv_rot, dkv_rot = elem * 2 * hkv * c * d, 4 * 2 * hkv * c * d
    log(phase, f"{label}: bytes one rotation would put on NVLink per rank (computed, not "
               f"measured): K/V {kv_rot / 1e6:.1f} MB ({kv_rot / NVLINK_BYTES_PER_S * 1e3:.4f} "
               f"ms at 450 GB/s), dK/dV f32 {dkv_rot / 1e6:.1f} MB "
               f"({dkv_rot / NVLINK_BYTES_PER_S * 1e3:.4f} ms); per ring {RING_RANKS - 1} K/V "
               f"rotations forward, {RING_RANKS - 1} K/V + {RING_RANKS} dK/dV backward")
    k7["step_ms"] = {key: t[0] for key, t in step_ms.items()}
    k8["step_ms"] = {key: t[1] for key, t in step_ms.items()}
    del out, leaves, o_ref
    torch.cuda.empty_cache()
    if window_inputs is not None:
        ring = ring_attention_kernel_sharded(ranks=RING_RANKS, causal=True, window=RING_WINDOW)
        q, k, v, do = window_inputs
        leaves = tuple(x.detach().requires_grad_(True) for x in (q, k, v))
        out = ring(*leaves)
        w_fwd = cuda_ms(lambda: ring(q, k, v), reps=5, trials=3)
        w_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), reps=3,
                        trials=3)
        msg = f"{label}: window {RING_WINDOW} at {RING_RANKS} x {c}: forward ring {w_fwd:.4f} ms, "
        msg += f"backward ring {w_bwd:.4f} ms"
        if not f32_in:
            band = flash_fwd.pair_mask(n, n, kv_valid_len=n, causal=True, segment_ids=None,
                                       window=RING_WINDOW, device=DEVICE)[0, 0]
            msg += (f"; SDPA with the band mask {sdpa_ms(q, k, v, attn_mask=band):.4f} / "
                    f"backward {sdpa_ms(q, k, v, do=do, attn_mask=band):.4f} ms")
            del band
        log(phase, msg + " (median CUDA-event time)")
        del out, leaves
        torch.cuda.empty_cache()
    return k7, k8


def phase_ring() -> dict:
    """Ring attention over virtual ranks (RING_CASES, bf16 at D <= 128):
    each case through _ring_case (autograd through
    ring_attention_kernel_sharded with exact K7 = K8 launch counts, against
    the plain ring and single-device K1 / K3); then K7's and K8's SASS
    (_tma_wgmma_sass) and a one-rank NCCL process group through
    ring_attention_kernel(group=); then _ring_timing at the main shape
    causal and with the window."""
    res = {}
    for i, case in enumerate(RING_CASES):
        out = _ring_case(i, case, torch.bfloat16, "ring")
        if case[0] == "1 rank":
            one = out
        if case[0] in ("causal", "window"):
            res[case[0]] = out
        else:
            del out
    _tma_wgmma_sass("ring", {f"{k} ring_{w}_sm90_kernel<{d}>"
                             for k, w in (("K7", "fwd"), ("K8", "bwd")) for d in (64, 128)})
    _nccl_one_rank(one["inputs"], one["got"], 2e-2, "ring")
    del one
    k7, k8 = _ring_timing(res["causal"]["inputs"], res["causal"]["err"], label="bf16",
                          phase="ring", window_inputs=res["window"]["inputs"])
    counts = res["causal"]["counts"]
    del res
    torch.cuda.empty_cache()
    return {"k7": k7, "k8": k8, "launches": counts}


def ring_wide_instantiations() -> set:
    """The ring kernels' f32 and D 256 forms, by instantiation_name."""
    return {"K7 d256 ring_fwd_wide_kernel", "K8 d256 ring_bwd_wide_kernel",
            "K7 f32 d256 fwd_f32_wide_kernel<0, 0, 0, 1>",
            *(f"K7 f32 fwd_f32_kernel<{d}, 0, 0, 0, 1>" for d in (64, 128)),
            *(f"K8 f32 bwd_f32_kernel<{d}, 0, 0, 0, 1>" for d in (64, 128, 256))}


def phase_ring_wide() -> dict:
    """The ring kernels' f32 and D 136-256 forms (RING_WIDE_CASES): each case
    through _ring_case (exact K7 = K8 and split bf16x3 launch counts; f32
    gated at FWD_TOL / BWD_TOL[f32], bf16 at [bf16] and relative L2 1e-2,
    against the plain ring in f32 with TF32 off and single-device K1 / K3);
    the new instantiations' SASS; a one-rank NCCL group in f32 at D 256;
    then _ring_timing of each form at the main shape (RING_WIDE_TIMED).
    Returns, per form, the `kernels` entries' numbers and the launches of
    the form's main-shape runs."""
    _f32_tf32_off()
    res, launches = {}, {}
    for i, (name, dtype, *case) in enumerate(RING_WIDE_CASES):
        out = _ring_case(100 + i, (name, *case), dtype, "ring wide")
        for key in ("K7", "K8"):
            launches[key] = launches.get(key, 0) + out["counts"][key]
        if name in RING_WIDE_TIMED or name.endswith("window") or name == "f32 D256 1 rank":
            res[name] = out
        else:
            del out
    _tma_wgmma_sass("ring wide", ring_wide_instantiations())
    _nccl_one_rank(res["f32 D256 1 rank"]["inputs"], res["f32 D256 1 rank"]["got"], 1e-3,
                   "ring wide")
    del res["f32 D256 1 rank"]
    forms = {}
    for name, form in RING_WIDE_TIMED.items():
        window = res.get(name.replace("causal", "window"), {}).get("inputs")
        k7, k8 = _ring_timing(res[name]["inputs"], res[name]["err"], label=form,
                              phase="ring wide", window_inputs=window)
        forms[form] = {"k7": k7, "k8": k8, "launches": {
            key: sum(r["counts"][key] for n, r in res.items()
                     if n.replace("window", "causal") == name) for key in ("K7", "K8")}}
        res.pop(name)
        res.pop(name.replace("causal", "window"), None)
        torch.cuda.empty_cache()
    log("ring wide", f"K7 / K8 launches over the phase's cases: {launches}")
    return forms


# ---------------------------------------------------------------------------
# The distribution layer: q / kv offsets on K1's dense route, K3 and the split
# route (the chunk pairs of the parallel paths), the paths themselves, and the
# sharded LM step on a virtual mesh.

# The sharded step (data, model, seq): 8 virtual ranks on one card, each with
# 8 query and 4 KV heads of 128 and 2048 of the 8192 tokens.
SHARDED_MESH = (1, 2, 4)
SHARDED_SEQ = 8192
SHARDED_LR = 1e-3
SHARDED_STEPS = 4  # lr=1e-3 steps on one batch, the first a warm-up: the loss must fall
SHARDED_LOSS_TOL = 2e-2
SHARDED_TIMED = 3  # timed lr=0 steps per layout after the counted one: median and spread
# The leaves whose sharded gradient (step.loss_and_grads) is held against
# autograd of the single-device lm_loss on an f32 copy of the model: the
# embedding and layer 0's attention projections, whose gradients run through
# every layer's attention (RoPE positions, the ring's partials and merge, the
# halo'd targets). Per leaf, the relative L2 over every rank's shard must stay
# within SHARDED_GRAD_FLOOR_X times the bf16 floor: the single-device bf16
# step's own distance from the f32 model, measured in the same run.
SHARDED_GRAD_LEAVES = ("embed", "layers.0.wq", "layers.0.wk", "layers.0.wv", "layers.0.wo")
SHARDED_GRAD_FLOOR_X = 1.5
# 8 packed documents whose edges miss the 2048-token shard edges: the
# second, fourth and sixth straddle one.
SHARDED_DOC_EDGES = (1536, 2560, 3584, 4608, 5632, 6656, 7680)
# The chunk pairs of the paths at a rank's width (B1 Hq8 Hkv4 D128): (name,
# Nq, Nk, options, q_offset, kv_offset) -- a diagonal pair, the contiguous
# ring's neighbour pair (every pair live; the timed one), an off-diagonal pair
# with delta > Nq, a window pair whose shifted left bound is negative and whose
# last row sees no key, zigzag's q_hi x k_lo, a ragged tail, delta < 0 (whole
# Q tiles that meet no KV tile, whole KV tiles that no row reaches) and the
# packed ring's neighbour pair, one document across the edge (the split
# route; timed too). q and k are drawn at GROW x unit scale.
OFFSET_CASES = [("diagonal", 2048, 2048, dict(causal=True), 4096, 4096),
                ("ring neighbour", 2048, 2048, dict(causal=True), 2048, 0),
                ("off-diagonal delta > Nq", 2048, 2048, dict(causal=True), 6144, 0),
                ("window lo < 0", 2048, 2048, dict(causal=True, window=(2047, -1)), 2048, 0),
                ("zigzag q_hi x k_lo", 1024, 1024, dict(causal=True), 7168, 1024),
                ("ragged tail", 1000, 1100, dict(causal=True), 1536, 512),
                ("delta < 0", 2048, 2048, dict(causal=True), 0, 1024),
                ("packed neighbour", 2048, 2048, dict(causal=True, ids=True), 2048, 0)]
PATH_RANKS = 4


def straddling_ids(n: int) -> torch.Tensor:
    """The packed documents of SHARDED_DOC_EDGES, int32 ``[1, n]``."""
    edges = torch.tensor(SHARDED_DOC_EDGES, device=DEVICE)
    return torch.bucketize(torch.arange(n, device=DEVICE), edges, right=True).to(torch.int32)[None]


def _offsets_case(tag: str, q, k, v, do, kw) -> dict:
    """K1's dense route and its backward (K3; the split route with segment
    ids) at one chunk pair's offsets against fwd_reference and
    bwd_reference / split_bwd_reference with the same offsets, on f32 copies
    of the bf16 inputs: O within FWD_TOL[bf16], LSE within 1e-3 on live
    rows, dQ / dK / dV within BWD_TOL[bf16], each within relative L2
    WINDOW_REL_L2; dead rows O = dQ = 0 exactly and LSE = ln2 · mask (to one
    f32 ulp); the keys that no row reaches dK = dV = 0 exactly; one launch
    each."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import (
        BWD_TOL, FWD_TOL, Tolerance, check_close, grad_gate)

    windowed = int("window" in kw)
    before = _launches()
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    _routed(f"K1 at {tag}", before, K1=1, K1_dense_sm90=1, K1_window=windowed)
    f32 = [x.float() for x in (q, k, v, do)]
    o_want, lse_want = flash_fwd.fwd_reference(*f32[:3], **kw)
    dead_lse = math.log(2.0) * DEFAULT_MASK_VALUE
    live = lse_want > dead_lse * 0.5
    dead = ~live
    ok_o, msg_o = check_close(o, o_want, FWD_TOL[torch.bfloat16], "O")
    ok_l, msg_l = check_close(lse[live], lse_want[live], Tolerance(LSE_ATOL, 0.0), "LSE")
    # ln2 · mask as the kernel forms it in f32 and as the plain version in
    # f64 differ by one ulp
    dead_ok = bool((o[dead] == 0).all()) and bool(
        ((lse[dead] - dead_lse).abs() <= abs(dead_lse) * 2.0 ** -23).all())
    rel_o = _rel(o.float(), o_want)
    err_o = (o.float() - o_want).abs().max().item()
    delta = (f32[3] * o_want).sum(-1)
    args = (q, k, v, do, lse_want, delta)
    before = _launches()
    if "segment_ids" in kw:
        got = flash_bwd.split_bwd(*args, **kw)
        torch.cuda.synchronize()
        _routed(f"the split route at {tag}", before, split_bwd=1)
        want = flash_bwd.split_bwd_reference(*f32, lse_want, delta, **kw)
    else:
        got = flash_bwd_fused.bwd(*args, **kw)
        torch.cuda.synchronize()
        _routed(f"K3 at {tag}", before, K3=1, K3_sm90=1)
        want = flash_bwd_fused.bwd_reference(*f32, lse_want, delta, **kw)
    names = ("dq", "dk", "dv")
    ok_g, why_g, err_g, _ = grad_gate(got, want, BWD_TOL[torch.bfloat16], names=names)
    rel = {n: _rel(a.float(), e) for n, a, e in zip(names, got, want) if e.norm() > 0}
    keep = flash_fwd.pair_mask(q.shape[2], k.shape[2], kv_valid_len=k.shape[2],
                               causal=kw["causal"], segment_ids=kw.get("segment_ids"),
                               device=DEVICE, window=kw.get("window"),
                               q_offset=kw["q_offset"], kv_offset=kw["kv_offset"])
    unreached = ~keep.any(dim=-2)[0, 0]
    zero_ok = (bool((got[0][dead] == 0).all()) and bool((got[1][:, :, unreached] == 0).all())
               and bool((got[2][:, :, unreached] == 0).all()))
    log("offsets", f"{tag}: q_offset {kw['q_offset']} kv_offset {kw['kv_offset']}, "
                   f"Nq{q.shape[2]} Nk{k.shape[2]}: K1 O max_abs_err {err_o:.3e} (budget "
                   f"{O_TOL_NAME}), relative L2 {rel_o:.2e}, LSE live max_abs_err "
                   f"{(lse[live] - lse_want[live]).abs().max().item() if live.any() else 0:.3e}; "
                   f"dQ/dK/dV max_abs_err {err_g:.3e} (budget BWD_TOL[bf16]), relative L2 "
                   + ", ".join(f"{n} {r:.2e}" for n, r in rel.items())
                   + f" (limit {WINDOW_REL_L2}); dead rows {int(dead.sum())} (O, dQ 0, LSE ln2 "
                   f"mask: {dead_ok}), keys no row reaches {int(unreached.sum())} (dK, dV 0: "
                   f"{zero_ok})")
    if not (ok_o and ok_l and ok_g):
        fail(f"offsets at {tag}: the kernels disagree with their plain versions: {msg_o}; "
             f"{msg_l}; {why_g}")
    if not (rel_o <= WINDOW_REL_L2 or not live.any()) or not all(
            r <= WINDOW_REL_L2 for r in rel.values()):
        fail(f"offsets at {tag}: relative L2 above {WINDOW_REL_L2}: O {rel_o}, {rel}")
    if not (dead_ok and zero_ok):
        fail(f"offsets at {tag}: dead rows or unreached keys not exactly 0")
    return {"fwd_err": err_o, "bwd_err": err_g}


def _offsets_timing(q, k, v, do, kw) -> tuple[dict, dict]:
    """K1's dense route and its backward (K3, or the split route with ids) at
    one chunk pair's offsets: times beside their plain versions, the bound
    over the pairs attended (chip_smoke.bound), and one library call on the
    same pair -- SDPA with the pair's band as ``attn_mask``, or compiled
    flex_attention with the offset ``mask_mod`` where there are ids."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd

    ids = kw.get("segment_ids")
    fwd = lambda: flash_fwd.fwd(q, k, v, **kw)  # noqa: E731
    o, lse = fwd()
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    bwd, bwd_ref = ((flash_bwd.split_bwd, flash_bwd.split_bwd_reference) if ids is not None
                    else (flash_bwd_fused.bwd, flash_bwd_fused.bwd_reference))
    mask = dict(kv_valid_len=k.shape[2], causal=True, segment_ids=ids, q_offset=kw["q_offset"],
                kv_offset=kw["kv_offset"])
    B, Hq, Nq, D = q.shape
    Nk = k.shape[2]
    stats = 4 * B * Hq * Nq
    fwd_row = {"ms": cuda_ms(fwd),
               "plain_ms": cuda_ms(lambda: flash_fwd.fwd_reference(q, k, v, **kw), reps=5),
               **bound(tensor_bytes(q, k, v, q) + stats, pair_flops(q, k, matmuls=2, **mask))}
    bwd_row = {"ms": cuda_ms(lambda: bwd(*args, **kw)),
               "plain_ms": cuda_ms(lambda: bwd_ref(*args, **kw), reps=5),
               # out: dQ, dK, dV as the function returns them (bf16; dK / dV at Hkv heads)
               **bound(tensor_bytes(q, k, v, do) + 2 * stats + tensor_bytes(q, k, v),
                       pair_flops(q, k, matmuls=5, **mask))}
    if ids is None:
        band = flash_fwd.pair_mask(Nq, Nk, device=DEVICE, **mask)[0, 0]
        fwd_row["library_ms"] = sdpa_ms(q, k, v, attn_mask=band)
        bwd_row["library_ms"] = sdpa_ms(q, k, v, do=do, attn_mask=band)
        call = "scaled_dot_product_attention(attn_mask=the pair's band, enable_gqa=True)"
    else:
        seg_q, seg_kv = ids
        dq_off = kw["q_offset"] - kw["kv_offset"]

        def mod(b, h, qi, kj):
            return (qi + dq_off >= kj) & (seg_q[b, qi] == seg_kv[b, kj])

        fwd_row["library_ms"] = flex_ms(q, k, v, scale=kw["scale"], mask_mod=mod)
        bwd_row["library_ms"] = flex_ms(q, k, v, scale=kw["scale"], do=do, mask_mod=mod)
        call = "flex_attention (torch.compile) with the offset causal + segment mask_mod"
    fwd_row["library_call"] = call
    bwd_row["library_call"] = f"the backward of {call}"
    return fwd_row, bwd_row


def _offsets_check() -> dict:
    """Every OFFSET_CASES pair through _offsets_case; the ring neighbour pair
    and the packed neighbour pair timed (_offsets_timing)."""
    ids = straddling_ids(SHARDED_SEQ)
    rows = {}
    for i, (name, Nq, Nk, opts, q_off, kv_off) in enumerate(OFFSET_CASES):
        q, k, v = _grown(1700 + i, 1, 8, Nq, 128, Nk, 4)
        do = _bnhd(make_do(1750 + i, 1, 8, Nq, 128))
        kw = dict(scale=128 ** -0.5, q_offset=q_off, kv_offset=kv_off, **opts)
        if kw.pop("ids", False):
            kw["segment_ids"] = (ids[:, q_off:q_off + Nq].contiguous(),
                                 ids[:, kv_off:kv_off + Nk].contiguous())
        err = _offsets_case(name, q, k, v, do, kw)
        if name in ("ring neighbour", "packed neighbour"):
            fwd_row, bwd_row = _offsets_timing(q, k, v, do, kw)
            fwd_row["max_abs_err"], bwd_row["max_abs_err"] = err["fwd_err"], err["bwd_err"]
            rows[name] = (fwd_row, bwd_row)
            for what, row in (("K1", fwd_row), ("backward", bwd_row)):
                log("offsets", f"{name} pair B1 Hq8 Hkv4 N{Nq} D128 bf16, {what}: "
                               f"{row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound "
                               f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
                               f"{ms_text(row['library_ms'])} ms (median CUDA-event time)")
        del q, k, v, do
        torch.cuda.empty_cache()
    return rows


def make_do(seed, B, H, N, D):
    """A bf16 output cotangent [B, N, H, D] (a BNHD view of it is the path's)."""
    from flashattn_tpu_torch.utils.testing import make_qkv

    return make_qkv(seed, B, H, N, D, device=DEVICE)[0].to(torch.bfloat16)


def _path_gate(tag: str, got, want) -> None:
    """A parallel path against the single-device flash_attention on the same
    bf16 inputs: O within FWD_TOL[bf16] and relative L2 REL_L2_LIMIT, dQ /
    dK / dV within relative L2 GRAD_REL_L2_LIMIT."""
    from flashattn_tpu_torch.utils.testing import FWD_TOL, check_close

    ok_o, msg_o = check_close(got[0], want[0], FWD_TOL[torch.bfloat16], "O")
    rel = {n: _rel(a.float(), b.float()) for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
    log("paths", f"{tag} vs single-device flash_attention: O max_abs_err "
                 f"{(got[0].float() - want[0].float()).abs().max().item():.3e} (budget "
                 f"{O_TOL_NAME}); relative L2 " + ", ".join(f"{n} {r:.2e}" for n, r in rel.items())
                 + f" (limits {REL_L2_LIMIT} / {GRAD_REL_L2_LIMIT})")
    if not ok_o or rel["o"] > REL_L2_LIMIT or max(rel[n] for n in ("dq", "dk", "dv")) > \
            GRAD_REL_L2_LIMIT:
        fail(f"{tag} disagrees with single-device flash_attention: {msg_o}; {rel}")


def _parallel_paths_check() -> dict:
    """Ring (causal, a (2047, -1) window, segment ids), zigzag and Ulysses
    attention on a seq = 4 VirtualMesh and head-parallel attention on model
    = 2, at the LM's attention B1 Hq16 Hkv8 N8192 D128 (q, k at GROW x unit
    scale), forward and gradients against single-device flash_attention,
    with exact launch counts: the live chunk pairs of each ring (10 causal,
    7 windowed, 2P + 1 = 9 per rank zigzag), one call per rank for Ulysses
    and head-parallel; no K7 / K8, bias route or quantized K1 launch."""
    from flashattn_tpu_torch import flash_attention
    from flashattn_tpu_torch.parallel import (
        head_parallel_attention, make_mesh, ring_attention_sharded,
        zigzag_ring_attention_sharded)
    from flashattn_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    P = PATH_RANKS
    q, k, v, do = _ring_inputs(1800, P, SHARDED_SEQ // P, 16, 8, 128, GROW)
    ids = straddling_ids(SHARDED_SEQ)
    seq, tp = make_mesh(seq=P), make_mesh(model=2)
    window = (2047, -1)
    ring_pairs = P * (P + 1) // 2
    win_pairs = 2 * P - 1
    zz_pairs = P * (2 * P + 1)

    def k1k3(n, **extra):
        return dict(K1=n, K1_dense_sm90=n, K3=n, K3_sm90=n, **extra)

    cases = [("ring causal", ring_attention_sharded(seq, causal=True), dict(causal=True), (),
              k1k3(ring_pairs)),
             ("ring window (2047, -1)", ring_attention_sharded(seq, causal=True, window=window),
              dict(causal=True, window=window), (), k1k3(win_pairs, K1_window=win_pairs)),
             ("ring segment ids", ring_attention_sharded(seq, causal=True, with_segment_ids=True),
              dict(causal=True, segment_ids=ids), (ids,),
              dict(K1=ring_pairs, K1_dense_sm90=ring_pairs, split_bwd=ring_pairs)),
             ("zigzag", zigzag_ring_attention_sharded(seq), dict(causal=True), (),
              k1k3(zz_pairs)),
             ("ulysses", ulysses_attention_sharded(seq, causal=True), dict(causal=True), (),
              k1k3(P)),
             ("head-parallel, model 2", head_parallel_attention(tp, causal=True),
              dict(causal=True), (), k1k3(2))]
    refs = {}
    launches = {}
    for name, fn, single_kw, extra, want in cases:
        key = tuple(sorted((n, str(x)) for n, x in single_kw.items()))
        if key not in refs:
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o = flash_attention(*leaves, **single_kw)
            refs[key] = (o.detach(), *torch.autograd.grad(o, leaves, do))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        _reset_launches()
        o = fn(*leaves, *extra)
        grads = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
        counts = _launches()
        log("paths", f"{name} (B1 Hq16 Hkv8 N{SHARDED_SEQ} D128, q, k x{GROW}): launches "
                     f"{ {n: c for n, c in counts.items() if c} } (expected {want})")
        if counts != _expect(**want):
            fail(f"{name} launched {counts}, expected {want} and no other")
        _path_gate(name, (o.detach(), *grads), refs[key])
        launches[name] = counts
        del o, grads, leaves
        torch.cuda.empty_cache()
    return launches


def _kernel_share(prof) -> tuple[float, float]:
    """(device ms of the ring's K1 / K3 / split launches, device ms of every
    kernel) from a torch.profiler run over CUDA activity."""
    names = ("fwd_dense_sm90_kernel", "bwd_sm90_kernel", "bwd_split_sm90_kernel")
    attn = total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        total += t
        if any(n in e.key for n in names):
            attn += t
    return attn / 1e3, total / 1e3


def _grad_rel_l2(mesh, grads, ref, specs) -> dict:
    """Per leaf of ``ref`` (global single-device gradients): the relative L2
    error of the ranks' sharded gradients ``grads`` against ``ref`` cut by
    the same specs, over every local rank's shard, in f32."""
    out = {}
    for name, want in ref.items():
        err = den = 0.0
        for g, w in zip((g[name] for g in grads), mesh.shard(want, specs[name])):
            err += (g.float() - w.float()).square().sum().item()
            den += w.float().square().sum().item()
        out[name] = math.sqrt(err / den) if den > 0 else math.inf
    return out


def _lm_truth(model, cfg, tokens, segs: dict) -> tuple[dict, dict, dict]:
    """Per layout of ``segs`` (name: segment ids or None): the single-device
    bf16 lm_loss, the gradients of SHARDED_GRAD_LEAVES of an f32 copy of the
    model (the xla arm, with remat) and the bf16 step's relative L2 distance
    from them (the floor a sharded step's gradients are gated by)."""
    from flashattn_tpu_torch.models import transformer as T

    named = dict(model.named_parameters())
    m32 = T.Transformer(dataclasses.replace(cfg, dtype=torch.float32, remat=True), device=DEVICE)
    m32.load_state_dict(model.state_dict())
    named32 = dict(m32.named_parameters())
    ref, truth, floor = {}, {}, {}
    for name, seg in segs.items():
        loss = T.lm_loss(model, tokens, cfg, segment_ids=seg)
        g16 = torch.autograd.grad(loss, [named[n] for n in SHARDED_GRAD_LEAVES])
        loss32 = T.lm_loss(m32, tokens, m32.cfg, attn_impl="xla", segment_ids=seg)
        g32 = torch.autograd.grad(loss32, [named32[n] for n in SHARDED_GRAD_LEAVES])
        ref[name], truth[name] = loss.item(), dict(zip(SHARDED_GRAD_LEAVES, g32))
        floor[name] = {n: _rel_l2({n: a}, {n: b}) for n, a, b in zip(SHARDED_GRAD_LEAVES, g16, g32)}
        del loss, g16, loss32, g32
    del m32, named32
    torch.cuda.empty_cache()
    return ref, truth, floor


def _sharded_lm() -> dict:
    """bench_lm's LM at full width and depth (443.1 M parameters, bf16, seeded
    weights) through models.transformer.make_sharded_train_step on a
    SHARDED_MESH VirtualMesh at [1, SHARDED_SEQ] tokens, in three layouts:
    contiguous, zigzag and packed (8 documents, three straddling a shard
    edge). Per layout one lr=0 step with the counters reset just before --
    its loss within SHARDED_LOSS_TOL of the single-device lm_loss (packed:
    the packed lm_loss), exact launch counts (per step: layers x model ranks
    x the live chunk pairs of a seq group: 10 contiguous, 2P + 1 = 9 per
    rank zigzag; the split route and no K3 packed; nothing else) -- then the
    step's gradients (step.loss_and_grads) of SHARDED_GRAD_LEAVES against
    autograd of the same lm_loss on an f32 copy of the model, each within
    SHARDED_GRAD_FLOOR_X times the single-device bf16 step's distance from
    it, SHARDED_TIMED timed lr=0 steps (median ms/step with its spread,
    tokens/s, peak GB) and one more under torch.profiler (the device time of
    every kernel and of the ring's K1 / K3 / split launches, beside the wall
    time). Contiguous: then SHARDED_STEPS lr=1e-3 steps on the same batch
    whose loss must fall."""
    from torch.profiler import ProfilerActivity, profile

    from flashattn_tpu_torch.models import transformer as T
    from flashattn_tpu_torch.parallel import make_mesh

    cfg = T.TransformerConfig(**LM_WIDTH)  # bf16
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = T.init_transformer(cfg, gen, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, (1, SHARDED_SEQ), generator=gen, device=DEVICE)
    ids = straddling_ids(SHARDED_SEQ)
    ref, truth, floor = _lm_truth(model, cfg, tokens, {"contiguous": None, "packed": ids})
    for d in (ref, truth, floor):
        d["zigzag"] = d["contiguous"]
    mesh = make_mesh(*SHARDED_MESH)
    data, tp, sp = SHARDED_MESH
    groups = cfg.n_layers * data * tp
    ring, zz = sp * (sp + 1) // 2, sp * (2 * sp + 1)
    layouts = {"contiguous": (None, dict(K1=groups * ring, K1_dense_sm90=groups * ring,
                                         K3=groups * ring, K3_sm90=groups * ring)),
               "zigzag": (None, dict(K1=groups * zz, K1_dense_sm90=groups * zz,
                                     K3=groups * zz, K3_sm90=groups * zz)),
               "packed": (ids, dict(K1=groups * ring, K1_dense_sm90=groups * ring,
                                    split_bwd=groups * ring))}
    n_tok = tokens.shape[1] - 1  # positions with a target
    tag = (f"LM {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params on a "
           f"(data {data}, model {tp}, seq {sp}) VirtualMesh, {list(tokens.shape)} tokens")
    out = {}
    for layout, (seg, want) in layouts.items():
        extra = () if seg is None else (seg,)
        shards = T.shard_params(model, mesh)
        opt = [T.adamw_init(p) for p in shards]
        step, specs, _ = T.make_sharded_train_step(
            mesh, cfg, lr=0.0, seq_layout="zigzag" if layout == "zigzag" else "contiguous",
            with_segment_ids=seg is not None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        _, _, loss = step(shards, opt, tokens, *extra)
        torch.cuda.synchronize()
        counts = _launches()
        loss = loss.item()
        _, grads = step.loss_and_grads(shards, tokens, *extra)
        rel = _grad_rel_l2(mesh, grads, truth[layout], specs)
        del grads
        secs = []
        for _ in range(SHARDED_TIMED):
            t0 = time.perf_counter()
            step(shards, opt, tokens, *extra)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        step_s = statistics.median(secs)
        peak = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(shards, opt, tokens, *extra)
            torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
        attn_ms, dev_ms = _kernel_share(prof)
        log("sharded", f"{tag}, {layout}: lr=0 loss {loss:.5f}, single-device lm_loss "
                       f"{ref[layout]:.5f}, |diff| {abs(loss - ref[layout]):.2e} (limit "
                       f"{SHARDED_LOSS_TOL}); gradients' relative L2 against the f32 model "
                       + ", ".join(f"{n} {e:.3e} (bf16 floor {floor[layout][n]:.3e})"
                                   for n, e in rel.items())
                       + f" (limit {SHARDED_GRAD_FLOOR_X} x floor); {step_s * 1e3:.1f} ms/step "
                       f"(median of "
                       f"{SHARDED_TIMED} after the counted step: "
                       f"{', '.join(f'{x * 1e3:.1f}' for x in secs)}), {n_tok / step_s:.0f} "
                       f"tokens/s, peak {peak:.2f} GB; launches "
                       f"{ {n: c for n, c in counts.items() if c} } (expected {want})")
        share = (f"{attn_ms:.2f} ms of {dev_ms:.2f} ms of kernel time "
                 f"({100 * attn_ms / dev_ms:.1f}%)" if dev_ms > 0 else "not measured (the "
                 "profiler saw no device time)")
        log("sharded", f"{layout}: one profiled step, {prof_ms:.1f} ms wall; the ring's "
                       f"K1 / K3 / split launches take {share}")
        if counts != _expect(**want):
            fail(f"the sharded step ({layout}) launched {counts}, expected {want} and no other")
        if not abs(loss - ref[layout]) <= SHARDED_LOSS_TOL:
            fail(f"the sharded step's loss ({layout}) {loss} vs single-device {ref[layout]}")
        if not all(e <= SHARDED_GRAD_FLOOR_X * floor[layout][n] for n, e in rel.items()):
            fail(f"the sharded step's gradients ({layout}) vs the f32 model: {rel}, above "
                 f"{SHARDED_GRAD_FLOOR_X} x the bf16 floor {floor[layout]}")
        out[layout] = {"counts": counts, "ms": step_s * 1e3, "ms_all": [x * 1e3 for x in secs],
                       "peak_gb": peak, "loss": loss, "grad_rel_l2": rel,
                       "grad_floor": floor[layout], "attn_ms": attn_ms,
                       "device_ms": dev_ms, "profiled_wall_ms": prof_ms}
        if layout == "contiguous":
            del shards, opt
            shards = T.shard_params(model, mesh)
            opt = [T.adamw_init(p) for p in shards]
            train, _, _ = T.make_sharded_train_step(mesh, cfg, lr=SHARDED_LR)
            losses, secs = [], []
            for _ in range(SHARDED_STEPS):
                t0 = time.perf_counter()
                _, _, lo = train(shards, opt, tokens)
                losses.append(lo.item())
                secs.append(time.perf_counter() - t0)
            step_s = statistics.median(secs[1:])
            log("sharded", f"{layout}: {SHARDED_STEPS} AdamW steps at lr {SHARDED_LR} on one "
                           f"batch, {step_s * 1e3:.1f} ms/step "
                           f"({', '.join(f'{x * 1e3:.1f}' for x in secs)}), {n_tok / step_s:.0f} "
                           f"tokens/s (median after 1 warm-up step); loss "
                           + " -> ".join(f"{x:.4f}" for x in losses))
            if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
                fail(f"sharded training: losses {losses} not finite or not falling")
            out[layout]["train_ms"] = step_s * 1e3
        del shards, opt
        torch.cuda.empty_cache()
    del model, truth
    torch.cuda.empty_cache()
    return out


def phase_sharded_train() -> dict:
    """The distribution layer on one card: q / kv offsets on K1's dense
    route, K3 and the split route at every chunk-pair kind the paths make
    (_offsets_check), ring / zigzag / Ulysses / head-parallel attention
    against single-device flash_attention (_parallel_paths_check), and the
    dp x tp x sp LM step at full width on an 8-rank VirtualMesh
    (_sharded_lm)."""
    rows = _offsets_check()
    paths = _parallel_paths_check()
    lm = _sharded_lm()
    return {"rows": rows, "paths": paths, "lm": lm}


# ───────────── the f32 routes (K1's f32 kernel, the f32 backward body) ─────────────

# (tag, B, Hq, Hkv, Nq, Nk, D, kw, ids kind as _seg_case_ids or None): ragged
# Nq 127 / 129 and Nk 63 / 77 with Nq != Nk, D 32 / 64 / 128 (D 32 in the
# D 64 box), GQA, causal, a window with both bounds, segment ids (a tuple at
# Nq != Nk, packed, and rows of a segment no key carries: dead rows), the
# cap, all of them at once over several tiles, the contiguous ring's chunk
# pairs (the neighbour pair, every pair live; kv_offset past q_offset: dead
# rows and keys no row reaches), and a decode shape (one query row, GQA).
F32_CASES = [
    ("Nq127 Nk63 causal GQA 4/2", 2, 4, 2, 127, 63, 64, dict(causal=True), None),
    ("Nq129 Nk77 window (40, 3) D32", 1, 4, 4, 129, 77, 32, dict(window=(40, 3)), None),
    ("Nq127 Nk129 causal ids", 2, 4, 2, 127, 129, 128, dict(causal=True), "tuple"),
    ("Nq129 Nk63 cap 5", 1, 4, 2, 129, 63, 128, dict(softcap=5.0), None),
    ("N1000 GQA 16/8 causal + window + packed ids + cap 50", 1, 16, 8, 1000, 1000, 128,
     dict(causal=True, window=(255, -1), softcap=50.0), "packed"),
    ("N300 dead rows", 1, 8, 8, 300, 300, 64, {}, "dead"),
    ("ring neighbour (512, 0)", 1, 8, 4, 512, 512, 128,
     dict(causal=True, q_offset=512, kv_offset=0), None),
    ("ring kv past q (0, 512)", 1, 8, 4, 1024, 512, 128,
     dict(causal=True, q_offset=0, kv_offset=512), None),
    ("decode Nq1 Nk500 GQA 8/2", 2, 8, 2, 1, 500, 128, {}, None),
    # The f32 backward's two consumers take a KV tile's visits in turn: an odd
    # count (5 Q tiles), one visit (consumer 1 idle), none (causal keys past
    # Nq: dK / dV 0), every other Q tile skipped by the ids (5 of 9 visited).
    ("Nq160 Nk200: five Q tiles a KV tile", 1, 4, 2, 160, 200, 128, {}, None),
    ("Nq20 Nk300: one Q tile a KV tile", 2, 4, 4, 20, 300, 64, {}, None),
    ("Nq100 Nk300 causal: KV tiles no Q tile meets", 1, 4, 2, 100, 300, 128,
     dict(causal=True), None),
    ("Nq288 ids skipping every other Q tile", 2, 4, 2, 288, 256, 128, {}, "alternate"),
]
# The reference's adversarial shape (flashattn_tpu/utils/testing.py:25-26,
# precision_test.py:34-38): B3 H7 N1537 D111 Nkv1234, non-causal, through
# flash_attention (D padded to 112) in bf16 and in f32.
ADVERSARIAL = (3, 7, 1537, 111, 1234)
# fp16 inputs with compute_dtype=float32 (the JAX package's fp16 accuracy
# cell, B1 H8 N1024 D64, at B2): O in fp16 carries fp16's rounding, 2^-11 of
# |O| <= ~1, so its budget is 1e-3 absolute and relative; it must also beat
# the same call computed in bf16.
FP16_F32_SHAPE = (2, 8, 1024, 64)
FP16_F32_TOL = (1e-3, 1e-3)
# The f32 LM (bench_lm.py's width, f32): gates at [1, 2049] fused vs xla, both
# f32 -- the loss within F32_LOSS_TOL and all gradients within
# F32_GRAD_REL_L2 relative L2 (the bf16 limit is 3e-2; f32 arms that differ
# only in the attention's summation order sit orders below) -- then
# F32_STEPS lr=1e-3 AdamW steps whose loss falls; unpacked, then 8 packed
# documents.
F32_LOSS_TOL = 1e-3
F32_GRAD_REL_L2 = 1e-3
F32_STEPS = 4


@contextlib.contextmanager
def _scratch_kept():
    """Keep, in order, every scratch that the f32 wrappers allocate for their
    C entries' split (f32_split.scratch), so that the pieces the card wrote
    there can be read after the call."""
    from flashattn_tpu_torch.ops import f32_split

    kept, make = [], f32_split.scratch
    f32_split.scratch = lambda *a: kept.append(make(*a)) or kept[-1]
    try:
        yield kept
    finally:
        f32_split.scratch = make


def _pieces_check(tag: str, pieces, operands, kv_valid_len: int) -> float:
    """The pieces that an f32 C entry's one split launch wrote into
    ``pieces`` (its scratch; the forward's operands q, k, v, the backward's
    q, k, v, dO, k and v cut to kv_valid_len) against split_reference of
    each, bit for bit; fails on any difference. Prints the pieces' sum
    against each operand, relative to |x|. Returns the largest |kernel piece
    - plain piece| (0 when bit for bit)."""
    from flashattn_tpu_torch.ops import f32_split

    xs = [x[:, :, :kv_valid_len] if i in (1, 2) else x for i, x in enumerate(operands)]
    D = xs[0].shape[-1]
    got = f32_split.operands(pieces, [tuple(x.shape[:3]) for x in xs], D)
    same, err, rel = True, 0.0, 0.0
    for g, x in zip(got, xs):
        want = f32_split.split_reference(x)
        same = same and torch.equal(g.view(torch.int16), want.view(torch.int16))
        err = max(err, (g.float() - want.float()).abs().max().item())
        big = x.abs() > 1e-30  # the sum's error relative to |x| (subnormals: absolute)
        rel = max(rel, ((g.float().sum(0)[..., :D] - x).abs()[big] / x.abs()[big]).max().item())
    log("f32", f"split at {tag} ({len(xs)} operands in one launch, kv_valid_len "
               f"{kv_valid_len}): pieces bit for bit {same}, max |kernel - plain| {err:.3e}; "
               f"|x0 + x1 + x2 - x| / |x| max {rel:.3e} (2^-24 = {2.0 ** -24:.3e})")
    if not same:
        fail(f"the split at {tag}: the kernel's pieces differ from split_reference's")
    return err


def _split_checked(tag: str, q, k, v, do, kw) -> float:
    """K1's f32 call and the f32 backward's (K3's) on these inputs, the
    launches exactly one kernel and one split each way, and the pieces each
    split wrote held against split_reference (_pieces_check); the larger of
    the two errors."""
    from flashattn_tpu_torch.ops import flash_bwd_fused, flash_fwd

    nkv = kw.get("kv_valid_len", k.shape[2])
    before = _launches()
    with _scratch_kept() as kept:
        o, lse = flash_fwd.fwd(q, k, v, **kw)
        torch.cuda.synchronize()
    _routed(f"K1 f32 at {tag}", before, K1=1, K1_f32=1, split_bf16x3=1)
    err = _pieces_check(f"{tag}, K1 f32", kept[0], (q, k, v), nkv)
    before = _launches()
    with _scratch_kept() as kept:
        flash_bwd_fused.bwd(q, k, v, do, lse, (do * o).sum(-1), **kw)
        torch.cuda.synchronize()
    _routed(f"K3 f32 at {tag}", before, K3=1, bwd_f32=1, split_bf16x3=1)
    return max(err, _pieces_check(f"{tag}, bwd f32", kept[0], (q, k, v, do), nkv))


def _split_check() -> None:
    """The f32 routes' operand split (csrc/split_bf16x3.cu) as the f32 C
    entries launch it -- once before K1's f32 kernel for q, k and v, once
    before the f32 backward for q, k, v and dO, each operand found by its
    block index -- read back from the scratch the wrappers allocated and
    held against split_reference bit for bit (_split_checked), on: the f32
    LM's shape as the models hand it over ([B, N, H, D] views, 16-byte
    loads); D 111 as flash_attention hands it over (padded to D 112 with a
    zero column: the kernels take D % 8 == 0); D 104 as [B, N, H, D] views one
    element into a wider row (4-byte loads: neither the address nor the
    strides are 16-byte multiples), GQA 6 / 3, Nq 300, Nk 400 cut to
    kv_valid_len 350; D 40 contiguous with special values in v (zeros of both
    signs, powers of two, f32's large and tiny exponents, subnormals, bf16's
    largest value). _f32_timing checks the split on the inputs it times."""
    gen = torch.Generator(device=DEVICE).manual_seed(21)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    special = torch.tensor([0.0, -0.0, 1.0, -2.0, 2.0 ** -20, 2.0 ** 100, 1e38, -3e38, 1e-30,
                            -1e-38, 1e-40, 1.4e-45, 3.3895e38, 1.0 + 2.0 ** -23], device=DEVICE)
    v40 = randn(2, 3, 50, 40)
    v40.view(-1)[:special.numel()] = special

    def pad111(*shape):  # flash_attention's zero column past D 111
        return torch.nn.functional.pad(_bnhd(randn(*shape, 111)), (0, 1))

    def off104(*shape):  # a [B, N, H, D] view one element into a 105-wide row
        B, H, N = shape
        return randn(B, N, H, 105)[..., 1:].transpose(1, 2)

    cases = {
        "the f32 LM's shape, [B, N, H, D] views": (
            _bnhd(randn(1, 16, LM_SEQ, 128)), _bnhd(randn(1, 8, LM_SEQ, 128)),
            _bnhd(randn(1, 8, LM_SEQ, 128)), _bnhd(randn(1, 16, LM_SEQ, 128)),
            dict(causal=True)),
        "D 111 padded to 112, H 7, N 300": (
            pad111(2, 7, 300), pad111(2, 7, 300), pad111(2, 7, 300), pad111(2, 7, 300),
            dict(causal=True)),
        "D 104 views at an odd offset, GQA 6/3, Nq 300, Nk 400, kv_valid_len 350": (
            off104(2, 6, 300), off104(2, 3, 400), off104(2, 3, 400), off104(2, 6, 300),
            dict(kv_valid_len=350)),
        "D 40 contiguous, special values in v": (
            randn(2, 3, 50, 40), randn(2, 3, 50, 40), v40, randn(2, 3, 50, 40), {}),
    }
    for tag, (q, k, v, do, kw) in cases.items():
        _split_checked(tag, q, k, v, do, dict(scale=q.shape[-1] ** -0.5, **kw))
    del cases
    torch.cuda.empty_cache()


def _split_device_ms(fn, reps: int = 20) -> float:
    """Device ms of one launch of the split kernel as an f32 wrapper ``fn``
    makes it (its C entry launches the split, then its attention kernel):
    the mean over the split launches that a torch.profiler run over CUDA
    activity records in ``reps`` calls (it can record fewer: 8 of 10 on an
    H100 in a process that had run the profiler before). Where it records
    fewer than half of them or no device time in each of the runs that
    _profiled makes, the device time of the whole call behind a backlog
    (queued_ms: the split and its attention kernel), an upper bound, said
    in the log; fails if it records more launches than calls."""

    def splits(events):
        return [e for e in events if "split_bf16x3_kernel" in e.key]

    events = splits(_profiled(fn, reps, lambda ev: sum(e.count for e in splits(ev)) >= reps / 2))
    n, t = sum(e.count for e in events), sum(e.device_time_total for e in events)
    log("f32", f"the profiler recorded {n} of the {reps} split launches, {t:.1f} us")
    if n > reps:
        fail(f"the profiler saw {n} split launches ({t} us) in {reps} f32 calls")
    if n < reps / 2 or t <= 0:
        ms = queued_ms(fn, reps=reps, trials=3)
        log("f32", f"the split not timed by the profiler: the whole call's device time behind "
                   f"a backlog instead, {ms:.4f} ms (an upper bound: the split and its "
                   f"attention kernel)")
        return ms
    return t / n / 1e3


def _f32_tf32_off() -> None:
    """Pin the plain versions to full f32: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32_case(tag: str, q, k, v, do, kw) -> dict:
    """K1's f32 kernel and the f32 backward body (K3 without ids or a cap,
    the split route with either) against fwd_reference and bwd_reference /
    split_bwd_reference with TF32 off, all inputs f32: O within FWD_TOL[f32],
    LSE within FWD_TOL[f32] on live rows, dQ / dK / dV within BWD_TOL[f32];
    dead rows O = dQ = 0 exactly and LSE = ln2 · mask (to one f32 ulp); keys
    no row reaches dK = dV = 0 exactly; exactly one launch of each, on the
    f32 kernels and no other."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, check_close, grad_gate

    kw = dict(scale=q.shape[-1] ** -0.5, **kw)
    wide = int(q.shape[-1] > 128)  # the D 256 forms
    variants = dict(K1_window=int("window" in kw), K1_softcap=int("softcap" in kw))
    before = _launches()
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    _routed(f"K1 f32 at {tag}", before, K1=1, K1_f32=1, K1_f32_d256=wide, split_bf16x3=1,
            **variants)
    o_want, lse_want = flash_fwd.fwd_reference(q, k, v, **kw)
    dead_lse = math.log(2.0) * DEFAULT_MASK_VALUE
    live = lse_want > dead_lse * 0.5
    dead = ~live
    tol_f, tol_b = FWD_TOL[torch.float32], BWD_TOL[torch.float32]
    ok_o, msg_o = check_close(o, o_want, tol_f, "O")
    ok_l, msg_l = check_close(lse[live], lse_want[live], tol_f, "LSE")
    dead_ok = bool((o[dead] == 0).all()) and bool(
        ((lse[dead] - dead_lse).abs() <= abs(dead_lse) * 2.0 ** -23).all())
    err_o = (o - o_want).abs().max().item()
    err_l = (lse[live] - lse_want[live]).abs().max().item() if live.any() else 0.0
    delta = (do * o_want).sum(-1)
    args = (q, k, v, do, lse_want, delta)
    split = "segment_ids" in kw or "softcap" in kw
    before = _launches()
    if split:
        got = flash_bwd.split_bwd(*args, **kw)
        torch.cuda.synchronize()
        _routed(f"the f32 split route at {tag}", before, split_bwd=1, bwd_f32=1,
                bwd_f32_d256=wide, split_bf16x3=1)
        want = flash_bwd.split_bwd_reference(*args, **kw)
    else:
        got = flash_bwd_fused.bwd(*args, **kw)
        torch.cuda.synchronize()
        _routed(f"K3 f32 at {tag}", before, K3=1, bwd_f32=1, bwd_f32_d256=wide, split_bf16x3=1)
        want = flash_bwd_fused.bwd_reference(*args, **kw)
    names = ("dq", "dk", "dv")
    ok_g, why_g, err_g, _ = grad_gate(got, want, tol_b, names=names)
    keep = flash_fwd.pair_mask(q.shape[2], k.shape[2], kv_valid_len=k.shape[2],
                               causal=kw.get("causal", False),
                               segment_ids=kw.get("segment_ids"), device=DEVICE,
                               window=kw.get("window"), q_offset=kw.get("q_offset", 0),
                               kv_offset=kw.get("kv_offset", 0))
    unreached = ~keep.any(dim=-2).any(dim=0)[0]
    zero_ok = (bool((got[0][dead] == 0).all()) and bool((got[1][:, :, unreached] == 0).all())
               and bool((got[2][:, :, unreached] == 0).all()))
    log("f32", f"{tag}: K1 f32 O max_abs_err {err_o:.3e}, LSE live max_abs_err {err_l:.3e} "
               f"(budget FWD_TOL[f32] {tol_f.atol} + {tol_f.rtol}|ref|, max|O ref| "
               f"{o_want.abs().max().item():.3f}); {'split route' if split else 'K3'} f32 "
               f"dQ/dK/dV max_abs_err {err_g:.3e} (budget BWD_TOL[f32] {tol_b.atol} + "
               f"{tol_b.rtol}|ref|, max|ref| "
               f"{max(x.abs().max().item() for x in want):.3f}); dead rows {int(dead.sum())} "
               f"(O, dQ 0, LSE ln2 mask: {dead_ok}), keys no row reaches "
               f"{int(unreached.sum())} (dK, dV 0: {zero_ok})")
    if not (ok_o and ok_l and ok_g):
        fail(f"f32 at {tag}: the kernels disagree with their plain versions: {msg_o}; {msg_l}; "
             f"{why_g}")
    if not (dead_ok and zero_ok):
        fail(f"f32 at {tag}: dead rows or unreached keys not exactly 0")
    return {"fwd_err": err_o, "bwd_err": err_g}


def _adversarial(dtype) -> dict:
    """flash_attention at ADVERSARIAL in ``dtype``, forward and backward
    (autograd), against autograd of the f32 oracle on the same values:
    FWD_TOL / BWD_TOL of ``dtype``; one launch each of K1's and the
    backward's kernels for ``dtype`` (bf16: the dense route and K3's Hopper
    kernel; f32: the f32 kernels), none other."""
    from flashattn_tpu_torch.ops.flash import flash_attention
    from flashattn_tpu_torch.ops.oracle import attention_reference
    from flashattn_tpu_torch.utils.testing import (
        BWD_TOL, FWD_TOL, check_close, grad_gate, make_qkv)

    B, H, N, D, Nk = ADVERSARIAL
    q, k, v = (x.to(dtype) for x in make_qkv(16, B, H, N, D, Nk=Nk, device=DEVICE))
    do = make_qkv(17, B, H, N, D, device=DEVICE)[0].to(dtype)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    before = _launches()
    o = flash_attention(*leaves)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    tag = f"B{B} H{H} N{N} D{D} Nkv{Nk} {str(dtype).split('.')[-1]}"
    if dtype == torch.float32:
        _routed(f"flash_attention at {tag}", before, K1=1, K1_f32=1, K3=1, bwd_f32=1,
                split_bf16x3=2)
    else:
        _routed(f"flash_attention at {tag}", before, K1=1, K1_dense_sm90=1, K3=1, K3_sm90=1)
    ref = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    o_want = attention_reference(*ref)
    want = torch.autograd.grad(o_want, ref, do.float())
    ok_o, msg_o = check_close(o, o_want.detach(), FWD_TOL[dtype], "O")
    ok_g, why_g, err_g, _ = grad_gate(grads, want, BWD_TOL[dtype])
    err_o = (o.float() - o_want).abs().max().item()
    log("f32", f"adversarial {tag} through flash_attention: O max_abs_err {err_o:.3e} (budget "
               f"FWD_TOL[{str(dtype).split('.')[-1]}] {FWD_TOL[dtype].atol}), dQ/dK/dV "
               f"max_abs_err {err_g:.3e} (budget BWD_TOL {BWD_TOL[dtype].atol} + "
               f"{BWD_TOL[dtype].rtol}|ref|)")
    if not (ok_o and ok_g):
        fail(f"adversarial {tag}: {msg_o}; {why_g}")
    return {"fwd_err": err_o, "bwd_err": err_g}


def _fp16_compute_f32() -> dict:
    """fp16 inputs through flash_attention with compute_dtype=float32 (the f32
    kernels, one launch each way) against the f32 oracle on the fp16 values:
    O within FP16_F32_TOL and closer than the default bf16 compute."""
    from flashattn_tpu_torch.ops.flash import flash_attention
    from flashattn_tpu_torch.ops.oracle import attention_reference
    from flashattn_tpu_torch.utils.testing import Tolerance, check_close, make_qkv

    B, H, N, D = FP16_F32_SHAPE
    q, k, v = (x.half() for x in make_qkv(18, B, H, N, D, device=DEVICE))
    want = attention_reference(q.float(), k.float(), v.float(), causal=True)
    before = _launches()
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o = flash_attention(*leaves, causal=True, compute_dtype=torch.float32)
    grads = torch.autograd.grad(o, leaves, torch.ones_like(o))
    torch.cuda.synchronize()
    _routed("fp16 with compute_dtype=float32", before, K1=1, K1_f32=1, K3=1, bwd_f32=1,
            split_bf16x3=2)
    o_bf16 = flash_attention(q, k, v, causal=True)
    err, err_bf16 = ((x.float() - want).abs().max().item() for x in (o, o_bf16))
    ok, msg = check_close(o, want, Tolerance(*FP16_F32_TOL), "O")
    log("f32", f"fp16 B{B} H{H} N{N} D{D} causal: compute_dtype=float32 O max_abs_err "
               f"{err:.3e} (budget {FP16_F32_TOL}), default bf16 compute {err_bf16:.3e}; "
               f"O / gradients in {o.dtype} / {grads[0].dtype}")
    if not (ok and err < err_bf16 and o.dtype == grads[0].dtype == torch.float16):
        fail(f"fp16 with compute_dtype=float32: {msg}; bf16 compute {err_bf16:.3e}")
    return {"err": err, "err_bf16": err_bf16}


def _sdpa_backend(q, k, v, **kw) -> str:
    """The backend of one ``scaled_dot_product_attention`` call on these
    inputs, read from a profile: the number of CUDA kernels it launches and
    the three that take the most device time (a fused backend is one
    kernel; the math backend is GEMMs around a softmax)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    kw.setdefault("enable_gqa", k.shape[1] != q.shape[1])
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, **kw)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                    key=lambda e: -e.device_time_total)
    top = "; ".join(f"{e.key[:70]} {e.device_time_total / 1e3:.3f} ms" for e in events[:3])
    return f"{len(events)} kernels, most time in: {top}" if events else "no CUDA kernel profiled"


def _f32_library_ms(q, k, v, do, lib_kw, bias_leaf=None) -> dict:
    """SDPA on the f32 inputs (TF32 off) at the two backends that take f32:
    the math backend with ``enable_gqa`` (the one SDPA picks for Hkv < Hq)
    and the memory-efficient backend on K / V expanded to the query heads
    before timing (it takes no GQA); for the forward (``do`` None) or the
    backward (with ``bias_leaf``, the ``attn_mask`` leaf, its gradient too;
    a backend that gives none is logged and left out). The faster one's ms
    and name."""
    from torch.nn.attention import SDPBackend

    group = q.shape[1] // k.shape[1]
    kx, vx = (x.repeat_interleave(group, 1) for x in (k, v))
    times = {"math backend": sdpa_ms(q, k, v, do=do, backend=SDPBackend.MATH,
                                     bias_leaf=bias_leaf, **lib_kw)}
    try:
        times["memory-efficient backend, K / V expanded"] = sdpa_ms(
            q, kx, vx, do=do, backend=SDPBackend.EFFICIENT_ATTENTION, bias_leaf=bias_leaf,
            **lib_kw)
    except RuntimeError as e:  # the backend refused these inputs: the math time stands
        log("f32", f"SDPA's memory-efficient backend refused"
                   f"{' (with the mask gradient)' if bias_leaf is not None else ''}: "
                   f"{str(e)[:200]}")
    name = min(times, key=times.get)
    log("f32", f"SDPA f32 {'backward' if do is not None else 'forward'}: "
               + ", ".join(f"{n} {t:.4f} ms" for n, t in times.items()))
    return {"library_ms": times[name], "library": f"SDPA f32, {name}"}


def _f32_timing(packed: bool) -> tuple[dict, dict, dict]:
    """K1's f32 kernel and the f32 backward at the f32 LM's attention (B1
    Hq16 Hkv8 N2048 D128 causal; ``packed``: 8 documents, the split route):
    each held against its plain version on these inputs (TF32 off; O within
    FWD_TOL[f32], LSE within it on live rows; dQ / dK / dV within
    BWD_TOL[f32]), its error in its row; ms, the plain versions' ms, the
    bounds (bytes at 3.35 TB/s, the pairs' products at
    PEAK_F32_ACCURATE_FLOPS) and the faster SDPA backend on the same f32
    inputs (a boolean block mask for the documents). Third, the split's row:
    the pieces that the checked calls' splits wrote held against
    split_reference bit for bit (_pieces_check), their largest difference
    its error; ms the device time of the forward's split launch (q, k and v,
    as K1's f32 C entry launches it; the backward's, which adds dO, beside
    it) from torch.profiler; the plain version on q, k and v; the bound,
    the bytes it moves."""
    from flashattn_tpu_torch.ops import f32_split, flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import (
        BWD_TOL, FWD_TOL, check_close, grad_gate, make_qkv)

    B, Hq, Hkv, N, D = 1, 16, 8, LM_SEQ, 128
    q, k, v = make_qkv(19, B, Hq, N, D, Hkv=Hkv, device=DEVICE)
    do = make_qkv(20, B, Hq, N, D, device=DEVICE)[0]
    ids = packed_ids(B, N) if packed else None
    kw = dict(scale=D ** -0.5, causal=True,
              segment_ids=None if ids is None else (ids, ids))
    tag = (f"{'packed ' if packed else ''}B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal"
           f"{' + 8 documents' if packed else ''}")
    with _scratch_kept() as kept:
        o, lse = flash_fwd.fwd(q, k, v, **kw)
        torch.cuda.synchronize()
    split_err = _pieces_check(f"{tag}, K1 f32 (the timed inputs)", kept[0], (q, k, v), N)
    o_want, lse_want = flash_fwd.fwd_reference(q, k, v, **kw)
    live = lse_want > math.log(2.0) * DEFAULT_MASK_VALUE * 0.5
    tol_f, tol_b = FWD_TOL[torch.float32], BWD_TOL[torch.float32]
    ok_o, msg_o = check_close(o, o_want, tol_f, "O")
    ok_l, msg_l = check_close(lse[live], lse_want[live], tol_f, "LSE")
    err_o = (o - o_want).abs().max().item()
    err_l = (lse[live] - lse_want[live]).abs().max().item()
    delta = (do * o).sum(-1)
    bwd = flash_bwd.split_bwd if packed else flash_bwd_fused.bwd
    bwd_ref = flash_bwd.split_bwd_reference if packed else flash_bwd_fused.bwd_reference
    if not packed:
        kw.pop("segment_ids")
    args = (q, k, v, do, lse, delta)
    with _scratch_kept() as kept:
        got = bwd(*args, **kw)
        torch.cuda.synchronize()
    split_err = max(split_err, _pieces_check(f"{tag}, bwd f32 (the timed inputs)", kept[0],
                                             (q, k, v, do), N))
    del kept
    want = bwd_ref(*args, **kw)
    ok_g, why_g, err_g, _ = grad_gate(got, want, tol_b)
    log("f32", f"{tag} (the timed inputs): K1 f32 O max_abs_err {err_o:.3e}, LSE live "
               f"max_abs_err {err_l:.3e} (budget FWD_TOL[f32] {tol_f.atol} + {tol_f.rtol}|ref|, "
               f"max|O ref| {o_want.abs().max().item():.3f}); "
               f"{'split route' if packed else 'K3'} f32 dQ/dK/dV max_abs_err {err_g:.3e} "
               f"(budget BWD_TOL[f32] {tol_b.atol} + {tol_b.rtol}|ref|, max|ref| "
               f"{max(x.abs().max().item() for x in want):.3f})")
    if not (ok_o and ok_l and ok_g):
        fail(f"f32 at {tag}: the kernels disagree with their plain versions: {msg_o}; "
             f"{msg_l}; {why_g}")
    del got, want, o_want, lse_want
    mask = dict(kv_valid_len=N, causal=True, segment_ids=kw.get("segment_ids"))
    lib_kw = (dict(is_causal=True) if ids is None else
              dict(attn_mask=flash_fwd.pair_mask(N, N, device=DEVICE, **mask)))
    rows = []
    for name, fn, plain, matmuls, nbytes, err, lib_do in (
            ("fwd", lambda: flash_fwd.fwd(q, k, v, **kw),
             lambda: flash_fwd.fwd_reference(q, k, v, **kw), 2,
             tensor_bytes(q, k, v, o, lse), err_o, None),
            ("bwd", lambda: bwd(*args, **kw), lambda: bwd_ref(*args, **kw), 5,
             tensor_bytes(q, k, v, do, lse, delta, q, q, q), err_g, do)):
        row = {"max_abs_err": err, "ms": cuda_ms(fn, reps=10, trials=5),
               "plain_ms": cuda_ms(plain, reps=2, trials=3),
               **bound(nbytes, pair_flops(q, k, matmuls=matmuls, **mask),
                       PEAK_F32_ACCURATE_FLOPS),
               **_f32_library_ms(q, k, v, lib_do, lib_kw)}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log("f32", f"{name} at {tag}: {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
                   f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {row['bound_share']:.1%} of "
                   f"it), {row['library']} {row['library_ms']:.4f} ms")
    log("f32", f"SDPA's f32 dispatch there (enable_gqa): {_sdpa_backend(q, k, v, **lib_kw)}")
    nbytes = tensor_bytes(q, k, v) * 10 // 4  # f32 read once, three bf16 pieces written (D 128)
    split = {"max_abs_err": split_err, "ms": _split_device_ms(lambda: flash_fwd.fwd(q, k, v, **kw)),
             "bwd_launch_ms": _split_device_ms(lambda: bwd(*args, **kw)),
             "plain_ms": cuda_ms(lambda: [f32_split.split_reference(x) for x in (q, k, v)],
                                 reps=5, trials=3),
             **bound(nbytes, 0.0), "library_ms": None}
    split["bound_share"] = split["bound_ms"] / split["ms"]
    log("f32", f"split at {tag}: K1 f32's launch (q, k, v) {split['ms']:.4f} ms device time, "
               f"the backward's (and dO) {split['bwd_launch_ms']:.4f} ms; plain (q, k, v) "
               f"{split['plain_ms']:.4f} ms; bound {split['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} "
               f"MB; {split['bound_share']:.1%} of it); pieces bit for bit, max |kernel - plain| "
               f"{split_err:.3e}")
    return rows[0], rows[1], split


def phase_f32_check() -> dict:
    """The split as the f32 C entries launch it against its plain version
    (_split_check); K1's f32 kernel and the f32 backward body against their
    plain versions (TF32 off) on every F32_CASES entry, q and k at GROW x
    unit scale (O(1) outputs: a missed band edge or a single-pass TF32
    product shows); the adversarial shape in bf16 and f32 through
    flash_attention; fp16 with compute_dtype=float32; then the kernels and
    the split held against their plain versions and timed at the f32 LM's
    attention (_f32_timing)."""
    from flashattn_tpu_torch.utils.testing import make_qkv

    _f32_tf32_off()
    _split_check()
    errs = []
    for i, (tag, B, Hq, Hkv, Nq, Nk, D, kw, ids) in enumerate(F32_CASES):
        q, k, v = make_qkv(300 + i, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv, device=DEVICE)
        do = make_qkv(400 + i, B, Hq, Nq, D, device=DEVICE)[0]
        kw = dict(kw)
        if ids is not None:
            kw["segment_ids"] = _seg_case_ids(ids, 500 + i, B, Nq, Nk)
        # [B, N, H, D] views, as the models hand them over
        q, k, v, do = (_bnhd(x) for x in (GROW * q, GROW * k, v, do))
        errs.append(_f32_case(tag, q, k, v, do, kw))
    adv = {str(dt).split(".")[-1]: _adversarial(dt) for dt in (torch.bfloat16, torch.float32)}
    fp16 = _fp16_compute_f32()
    fwd, bwd, split = _f32_timing(packed=False)
    fwd_p, bwd_p, _ = _f32_timing(packed=True)
    worst = {n: max(e[n] for e in errs) for n in ("fwd_err", "bwd_err")}
    log("f32", f"all {len(F32_CASES)} cases: worst O {worst['fwd_err']:.3e}, worst dQ/dK/dV "
               f"{worst['bwd_err']:.3e}")
    _tma_wgmma_sass("f32", f32_instantiations(bias=False))
    return {"fwd": fwd, "bwd": bwd, "fwd_packed": fwd_p, "bwd_packed": bwd_p, "split": split,
            "cases_worst": worst, "adversarial": adv, "fp16": fp16}


def _f32_lm_gates(cfg, tokens, segment_ids, tag: str) -> None:
    """The f32 LM's gates, fused against xla on the same seed-0 weights: the
    loss within F32_LOSS_TOL, all gradients within F32_GRAD_REL_L2 relative
    L2, both finite."""
    from flashattn_tpu_torch.models.transformer import init_transformer, lm_loss

    model = init_transformer(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)

    def loss_and_grads(arm):
        model.zero_grad(set_to_none=True)
        loss = lm_loss(model, tokens, cfg, attn_impl=arm, segment_ids=segment_ids)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    lf, gf = loss_and_grads("fused")
    lx, gx = loss_and_grads("xla")
    rel = _rel_l2(gf, gx)
    finite = math.isfinite(lf) and all(torch.isfinite(t).all() for t in gf.values())
    log("f32 train", f"{tag} LM ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
                     f"params, f32) on {list(tokens.shape)} tokens: loss fused {lf:.6f}, xla "
                     f"{lx:.6f}, |diff| {abs(lf - lx):.2e} (limit {F32_LOSS_TOL}); gradients "
                     f"relative L2 {rel:.3e} (limit {F32_GRAD_REL_L2})")
    if not (finite and abs(lf - lx) <= F32_LOSS_TOL and rel <= F32_GRAD_REL_L2):
        fail(f"f32 LM gates ({tag}): loss {lf} vs {lx}, gradients relative L2 {rel}")
    del model, gf, gx
    torch.cuda.empty_cache()


def phase_f32_train() -> dict:
    """bench_lm's LM at full width in f32 (LM_WIDTH, dtype float32): the
    gates at [1, 2049], then F32_STEPS fused lr=1e-3 AdamW steps whose loss
    falls, with exactly n_layers x F32_STEPS launches of K1's f32 kernel and
    of the f32 backward (as K3) and none of a bf16 kernel; then the same
    with 8 packed documents (the f32 backward as the split route)."""
    from flashattn_tpu_torch.models.transformer import TransformerConfig

    _f32_tf32_off()
    cfg = TransformerConfig(**LM_WIDTH, dtype=torch.float32)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_SEQ + 1), generator=gen, device=DEVICE)
    expected = cfg.n_layers * F32_STEPS
    counts = {}
    for tag, ids, bwd in (("unpacked", None, "K3"), ("packed", packed_ids(1, LM_SEQ + 1),
                                                     "split_bwd")):
        _f32_lm_gates(cfg, tokens, ids, tag)
        _reset_launches()
        _lm_steps(cfg, tokens, "fused", ids, phase="f32 train", label=f"f32 fused, {tag}",
                  steps=F32_STEPS, warmup=1)
        counts[tag] = _launches()
        want = _expect(K1=expected, K1_f32=expected, bwd_f32=expected, split_bf16x3=2 * expected,
                       **{bwd: expected})
        log("f32 train", f"{tag}: launches {counts[tag]} (expected K1 = K1 f32 = "
                         f"{bwd.replace('_', ' ')} = bwd f32 = {cfg.n_layers} layers x "
                         f"{F32_STEPS} steps = {expected}, split bf16x3 = 2 x {expected}, no "
                         "bf16 kernel)")
        if counts[tag] != want:
            fail(f"f32 LM steps ({tag}) launched {counts[tag]}, expected {want}")
    return counts


def f32_instantiations(*, bias: bool) -> set:
    """The instantiations of K1's f32 route (fwd_f32_kernel<D, SEG, CAP,
    BIAS>) and of the f32 backward (bwd_f32_kernel<D, SEG, CAP, BIAS>) with
    or without the bias, as instantiation_name names them: 8 + 8."""
    b = int(bias)
    return {f"{name}{' bias' if bias else ''}{' segments' if sg else ''}"
            f"{' softcap' if cp else ''} {kind}_f32_kernel<{d}, {sg}, {cp}, {b}>"
            for name, kind in (("K1 f32", "fwd"), ("bwd f32", "bwd"))
            for d in (64, 128) for sg in (0, 1) for cp in (0, 1)}


# f32 with a bias (K1's f32 route's BIAS family, the f32 backward's BIAS
# family with and without dbias) against the plain versions, TF32 off, q and
# k at GROW x unit scale: (tag, B, Hq, Hkv, Nq, Nk, D, kv_valid_len, options,
# ids kind as _seg_case_ids or None, bias dims). The bias dims say which of
# (batch, head, row) the bias has -- the eight broadcast shapes [1|B, 1|Hq,
# Nq|1, Nk] once each -- or "padding": the key-padding bias [B, 1, N, N] of
# lengths (N, 100), whose rows past 100 are dead. Nk 77 and 513 give bias
# rows that the forward's wrapper pads to 16 bytes; D 72 runs in the D 128
# boxes; D 64 in the BIAS family's two-stage ring.
F32_BIAS_CASES = [
    ("causal GQA 4/2, Nk 77, bias [B, H, Nq, Nk]", 2, 4, 2, 127, 77, 64, 77,
     dict(causal=True), None, (1, 1, 1)),
    ("kv_valid_len 150 of Nk 200, bias [1, 1, 1, Nk]", 2, 4, 4, 129, 200, 128, 150, {}, None,
     (0, 0, 0)),
    ("key padding, dead rows, bias [B, 1, N, N]", 2, 4, 4, 256, 256, 128, 256, {}, None,
     "padding"),
    ("window (64, 32), D 72, bias [1, H, Nq, Nk]", 1, 4, 2, 300, 300, 72, 300,
     dict(window=(64, 32)), None, (0, 1, 1)),
    ("random ids, bias [B, H, 1, Nk]", 2, 4, 2, 256, 256, 64, 256, {}, "random", (1, 1, 0)),
    ("causal, q_off - kv_off 100, GQA 4/1, bias [1, H, 1, Nk]", 1, 4, 1, 200, 300, 128, 300,
     dict(causal=True, q_offset=100, kv_offset=0), None, (0, 1, 0)),
    ("Nq 1, cap 5, bias [B, 1, 1, Nk]", 2, 4, 2, 1, 513, 128, 513, dict(softcap=5.0), None,
     (1, 0, 0)),
    ("window (40, 40), ids, q_off - kv_off 30, cap 5, bias [1, 1, Nq, Nk]", 2, 4, 2, 200, 260,
     64, 260, dict(window=(40, 40), q_offset=30, kv_offset=0, softcap=5.0), "tuple",
     (0, 0, 1)),
    ("causal GQA 8/1, Nq 129 < Nk 1000, kv_valid_len 900, bias [B, 1, Nq, Nk]", 1, 8, 1, 129,
     1000, 128, 900, dict(causal=True), None, (1, 0, 1)),
    # The two consumers' walk: every other Q tile skipped by the ids (3 of 5
    # visited, Nq not a multiple of the Q tile; dbias zero-filled on the
    # skipped tiles' pairs), and one Q tile a KV tile.
    ("Nq 150, ids skipping every other Q tile, bias [B, H, Nq, Nk]", 2, 4, 2, 150, 160, 128,
     160, {}, "alternate", (1, 1, 1)),
    ("Nq 20, Nk 300: one Q tile a KV tile, bias [B, 1, Nq, Nk]", 1, 4, 4, 20, 300, 64, 300, {},
     None, (1, 0, 1)),
]
# The cases that also run the backward without dbias (its dQ / dK / dV must
# equal the dbias launch's to BWD_TOL[f32] as well).
F32_BIAS_NO_DBIAS = (1, 5, 9)
# f32 path A (phase_f32_bias_train): AdamW steps per arm, the first a warm-up,
# and the gate: the fused arm's loss, all its gradients and (learned arm) the
# bias's gradient alone against the plain f32 function within this relative
# error (the f32 LM's limit).
F32_PATH_A_STEPS = 4
F32_PATH_A_REL = 1e-3


def f32_bwd_walk(Nq: int, kv_valid_len: int, *, causal: bool = False, segment_ids=None):
    """The (Q tile, KV tile) pairs that the f32 backward body visits, as a
    bool [B (1 without ids), q_tiles, kv_tiles] tensor: the CTA of KV tile n
    walks the Q tiles from the band's first row on (causal without offsets:
    row n * F32_BWD_KV_TILE) that, with segment ids, have an id range
    (flash_fwd.sm90_segments' tiles) meeting the KV tile's
    (csrc/flash_bwd_f32.cu: m_begin, next_visit); its two consumers take
    the visits of a KV tile in turn."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_fwd

    qt, kt = flash_bwd.F32_BWD_Q_TILE, flash_bwd.F32_BWD_KV_TILE
    n_q, n_k = -(-Nq // qt), -(-kv_valid_len // kt)
    dev = "cpu" if segment_ids is None else segment_ids[0].device
    t, n = torch.arange(n_q, device=dev)[:, None], torch.arange(n_k, device=dev)[None, :]
    visit = (t >= n * kt // qt if causal else torch.ones((n_q, n_k), dtype=torch.bool,
                                                          device=dev))[None]
    if segment_ids is not None:
        _, _, q_rng, kv_rng = flash_fwd.sm90_segments(segment_ids, Nq, kv_valid_len, q_tile=qt,
                                                      kv_tile=kt, pad_q=True)
        visit = visit & (q_rng[:, :, None, 0] <= kv_rng[:, None, :, 1]) & (
            kv_rng[:, None, :, 0] <= q_rng[:, :, None, 1])
    return visit


def _f32_bias_input(seed: int, B, Hq, Hkv, Nq, Nk, D, dims):
    """q, k (GROW) and v, dO, f32 on the card, and the case's f32 bias."""
    from flashattn_tpu_torch.utils.testing import make_qkv

    q, k, v = make_qkv(seed, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv, device=DEVICE)
    do = make_qkv(seed + 1, B, Hq, Nq, D, device=DEVICE)[0]
    if dims == "padding":
        bias = _padding_bias((Nq, 100), Nq)
    else:
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)
        shape = (B if dims[0] else 1, Hq if dims[1] else 1, Nq if dims[2] else 1, Nk)
        bias = torch.randn(shape, generator=gen, device=DEVICE)
    return GROW * q, GROW * k, v, do, bias


def _f32_bias_case(tag: str, q, k, v, do, bias, kw, *, no_dbias: bool) -> dict:
    """K1's f32 route with the bias and the f32 backward's BIAS family (with
    dbias, and with ``no_dbias`` also without) against fwd_reference and
    bias_bwd_reference with TF32 off: O within FWD_TOL[f32], LSE within it on
    live rows, dQ / dK / dV (per KV head) / dbias within BWD_TOL[f32]; dead
    rows' O = 0 and LSE = ln2 · mask bit for bit, their dQ and dbias 0;
    dbias exactly 0 on every pair the masks drop (flash_fwd.pair_mask: the
    band, the ids, the KV tail), read from memory the allocator hands out
    NaN-filled (_poison_cache); exactly one launch of each kernel and of
    the split, none of a bf16 kernel."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, check_close, grad_gate

    kw = dict(scale=q.shape[-1] ** -0.5, bias=bias, **kw)
    wide = int(q.shape[-1] > 128)  # the D 256 forms
    variants = dict(K1_window=int("window" in kw), K1_softcap=int("softcap" in kw))
    before = _launches()
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    _routed(f"K1 f32 bias at {tag}", before, K1=1, K1_bias=1, K1_f32=1, K1_f32_bias=1,
            K1_f32_d256=wide, split_bf16x3=1, **variants)
    o_want, lse_want = flash_fwd.fwd_reference(q, k, v, **kw)
    live = lse_want > math.log(2.0) * DEFAULT_MASK_VALUE * 0.5
    dead = ~live
    tol_f, tol_b = FWD_TOL[torch.float32], BWD_TOL[torch.float32]
    ok_o, msg_o = check_close(o, o_want, tol_f, "O")
    ok_l, msg_l = check_close(lse[live], lse_want[live], tol_f, "LSE")
    dead_ok = bool((o[dead] == 0).all()) and bool((lse[dead] == _dead_lse()).all())
    err_o = (o - o_want).abs().max().item()
    delta = (do * o_want).sum(-1)
    args = (q, k, v, do, lse_want, delta)
    nkv = kw.get("kv_valid_len", k.shape[2])
    drop = ~flash_fwd.pair_mask(q.shape[2], k.shape[2], kv_valid_len=nkv,
                                causal=kw.get("causal", False), segment_ids=kw.get("segment_ids"),
                                device=DEVICE, window=kw.get("window"),
                                q_offset=kw.get("q_offset", 0), kv_offset=kw.get("kv_offset", 0))
    want = flash_bwd.bias_bwd_reference(*args, want_dbias=True, **kw)
    errs, masked = [], 0
    for dbias in (True, False) if no_dbias else (True,):
        b, hq, nq, d = q.shape
        _poison_cache(8 * (b * hq * nq * (k.shape[2] + d) + 2 * b * hq * k.shape[2] * d))
        before = _launches()
        got = flash_bwd.bias_bwd(*args, want_dbias=dbias, **kw)
        torch.cuda.synchronize()
        _routed(f"the f32 bias backward at {tag} (dbias {dbias})", before, bias_bwd=1,
                bias_bwd_f32=1, bias_bwd_dbias=int(dbias), bwd_f32=1, bwd_f32_d256=wide,
                split_bf16x3=1)
        names = ("dq", "dk", "dv", "dbias")[:4 if dbias else 3]
        ok_g, why_g, err_g, _ = grad_gate(got[:len(names)], want[:len(names)], tol_b,
                                          names=names)
        if not ok_g:
            fail(f"f32 bias at {tag}: the backward (dbias {dbias}) disagrees with "
                 f"bias_bwd_reference: {why_g}")
        dead_ok = dead_ok and bool((got[0][dead] == 0).all())
        if dbias:
            dead_ok = dead_ok and bool((got[3][dead.expand(got[3].shape[:3])] == 0).all())
            masked = int((got[3][drop.expand(got[3].shape)] != 0).sum())
        errs.append(err_g)
        del got
    log("f32 bias", f"{tag}: K1 f32 bias O max_abs_err {err_o:.3e}, LSE live max_abs_err "
                    f"{(lse[live] - lse_want[live]).abs().max().item() if live.any() else 0:.3e} "
                    f"(budget FWD_TOL[f32] {tol_f.atol} + {tol_f.rtol}|ref|, max|O ref| "
                    f"{o_want.abs().max().item():.3f}); the f32 bias backward dQ/dK/dV/dbias "
                    f"max_abs_err {errs[0]:.3e}" + (f" (without dbias {errs[1]:.3e})"
                                                    if len(errs) > 1 else "")
                    + f" (budget BWD_TOL[f32] {tol_b.atol} + {tol_b.rtol}|ref|, max|ref| "
                    f"{max(x.abs().max().item() for x in want):.3f}); dead rows "
                    f"{int(dead.sum())} (O, dQ, dbias 0, LSE ln2 · mask bit for bit: "
                    f"{dead_ok}); dbias on the {int(drop.sum())} dropped pairs: {masked} not "
                    f"exactly 0")
    if not (ok_o and ok_l):
        fail(f"f32 bias at {tag}: K1 disagrees with fwd_reference: {msg_o}; {msg_l}")
    if not dead_ok or masked:
        fail(f"f32 bias at {tag}: dead rows or dropped pairs not exactly 0 ({masked} dbias)")
    del want
    torch.cuda.empty_cache()
    return {"fwd_err": err_o, "bwd_err": max(errs)}


def _f32_bias_timing(H: int = ATTN_WIDTH["num_heads"], D: int = 128,
                     phase: str = "f32 bias") -> dict:
    """K1's f32 route with the bias and the f32 backward's BIAS family at f32
    path A's attention (B4 H N2048 D, f32: H16 D128, or with heads of 256 H8
    D256, the D 256 forms): the mask arm's bias (the
    key-padding [4, 1, N, N] of ATTN_LENGTHS) and the learned arm's (that
    plus a [1, H, N, N] normal: [4, H, N, N]), the backward without dbias
    on the first and with it on the second. Each held against its plain
    version on these inputs (TF32 off: O within FWD_TOL[f32], dQ / dK / dV /
    dbias within BWD_TOL[f32]), its error in its row; ms, the kernels' own
    device ms (kernels_ms: the split and the attention kernel), the plain
    version's ms, the bound (each input read once, each output written
    once, at 3.35 TB/s; the products over every pair -- the kernels read the
    bias to learn which pairs it masks -- at PEAK_F32_ACCURATE_FLOPS) and the
    faster of SDPA's two f32 backends with the bias as ``attn_mask`` (the
    backward with ``attn_mask``'s gradient on the dbias row, where a backend
    gives one)."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
    from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, check_close, grad_gate, \
        make_qkv

    B, N = len(ATTN_LENGTHS), ATTN_SEQ
    q, k, v = make_qkv(31, B, H, N, D, device=DEVICE)
    do = make_qkv(32, B, H, N, D, device=DEVICE)[0]
    mask = _padding_bias(ATTN_LENGTHS, N)
    gen = torch.Generator(device=DEVICE).manual_seed(33)
    learned = mask + torch.randn((1, H, N, N), generator=gen, device=DEVICE)
    scale = D ** -0.5
    rows = {}
    for arm, bias, dbias in (("mask", mask, False), ("learned", learned, True)):
        kw = dict(scale=scale, bias=bias)
        o, lse = flash_fwd.fwd(q, k, v, **kw)
        o_want, lse_want = flash_fwd.fwd_reference(q, k, v, **kw)
        ok_o, msg_o = check_close(o, o_want, FWD_TOL[torch.float32], "O")
        err_o = (o - o_want).abs().max().item()
        delta = (do * o).sum(-1)
        args = (q, k, v, do, lse, delta)
        got = flash_bwd.bias_bwd(*args, want_dbias=dbias, **kw)
        want = flash_bwd.bias_bwd_reference(*args, want_dbias=dbias, **kw)
        n = 4 if dbias else 3
        ok_g, why_g, err_g, _ = grad_gate(got[:n], want[:n], BWD_TOL[torch.float32],
                                          names=("dq", "dk", "dv", "dbias")[:n])
        log(phase, f"path A's {arm} bias {list(bias.shape)} (the timed inputs): K1 f32 "
                   f"bias O max_abs_err {err_o:.3e}; the f32 bias backward"
                   f"{' with dbias' if dbias else ''} max_abs_err {err_g:.3e}")
        if not (ok_o and ok_g):
            fail(f"f32 bias at path A's {arm} shape: {msg_o}; {why_g}")
        del got, want, o_want, lse_want
        torch.cuda.empty_cache()
        pairs = float(B * H * N * N)
        leaf = bias.detach().requires_grad_(True) if dbias else None
        lib_kw = dict(attn_mask=bias if leaf is None else leaf)
        for name, fn, plain, matmuls, nbytes, err, lib_do in (
                ("fwd", lambda: flash_fwd.fwd(q, k, v, **kw),
                 lambda: flash_fwd.fwd_reference(q, k, v, **kw), 2,
                 tensor_bytes(q, k, v, bias, o, lse), err_o, None),
                ("bwd", lambda: flash_bwd.bias_bwd(*args, want_dbias=dbias, **kw),
                 lambda: flash_bwd.bias_bwd_reference(*args, want_dbias=dbias, **kw), 5,
                 tensor_bytes(q, k, v, do, lse, delta, bias, q, k, v,
                              bias.expand(B, H, N, N) if dbias else None), err_g, do)):
            row = {"max_abs_err": err, "ms": cuda_ms(fn, reps=5, trials=5),
                   "kernel_ms": kernels_ms(fn, reps=5),
                   "plain_ms": cuda_ms(plain, reps=1, trials=3),
                   **bound(nbytes, 2.0 * D * pairs * matmuls, PEAK_F32_ACCURATE_FLOPS),
                   **_f32_library_ms(q, k, v, lib_do, lib_kw, bias_leaf=leaf)}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            rows[f"{name}_{arm}"] = row
            log(phase, f"{name} at path A's {arm} arm (B{B} H{H} N{N} D{D} f32, bias "
                       f"{list(bias.shape)}{', dbias' if dbias and name == 'bwd' else ''}): "
                       f"{row['ms']:.3f} ms (kernels alone {row['kernel_ms']:.3f} ms), plain "
                       f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                       f"({row['bound_by']}; {row['bound_share']:.1%} of it), {row['library']} "
                       f"{row['library_ms']:.4f} ms ({_card_name()}; {_card_state()})")
        del o, lse, args, delta
        torch.cuda.empty_cache()
    return rows


def phase_f32_bias_check() -> dict:
    """K1's f32 route with a bias and the f32 backward's BIAS family (with
    and without dbias) against their plain versions on every F32_BIAS_CASES
    entry (_f32_bias_case), TF32 off; the new instantiations' SASS: HGMMA,
    UTMALDG, no HMMA; then both timed at f32 path A's shape (_f32_bias_timing)."""
    _f32_tf32_off()
    errs = []
    for i, (tag, B, Hq, Hkv, Nq, Nk, D, nkv, kw, ids, dims) in enumerate(F32_BIAS_CASES):
        q, k, v, do, bias = _f32_bias_input(600 + 10 * i, B, Hq, Hkv, Nq, Nk, D, dims)
        kw = dict(kw, kv_valid_len=nkv)
        if ids is not None:
            kw["segment_ids"] = _seg_case_ids(ids, 700 + i, B, Nq, Nk)
        errs.append(_f32_bias_case(f"B{B} Hq{Hq} Hkv{Hkv} Nq{Nq} Nk{Nk} D{D}, {tag}", q, k, v,
                                   do, bias, kw, no_dbias=i in F32_BIAS_NO_DBIAS))
    worst = {n: max(e[n] for e in errs) for n in ("fwd_err", "bwd_err")}
    log("f32 bias", f"all {len(F32_BIAS_CASES)} cases: worst O {worst['fwd_err']:.3e}, worst "
                    f"dQ/dK/dV/dbias {worst['bwd_err']:.3e}")
    _tma_wgmma_sass("f32 bias", f32_instantiations(bias=True))
    rows = _f32_bias_timing()
    return {**rows, "cases_worst": worst}


def _f32_path_a(arm: str, x, target, valid, mask, rel0, *, width: dict = ATTN_WIDTH,
                phase: str = "f32 bias_train") -> dict:
    """One arm of f32 path A: FlashMultiHeadDotProductAttention (``width``,
    ATTN_WIDTH or WIDE_ATTN_WIDTH's heads of 256, whose kernels are the D 256
    forms) at its default float32, impl "fused", on ``x`` with the key-padding
    ``mask`` and, where ``rel0`` is given, a trainable f32 bias initialised to
    it; an MSE loss over the valid rows. Gate (TF32 off): the fused arm's
    loss, all its gradients and, with the learned bias, that bias's gradient
    alone against the plain f32 function (_plain_mhdpa on the same weights,
    the mask folded into its bias) within F32_PATH_A_REL relative error.
    Then F32_PATH_A_STEPS AdamW steps whose loss falls, each launching
    exactly one split and one K1 f32 bias kernel forward, one f32 bias
    backward (with dbias on the learned arm) and its split, and no bf16
    kernel; ms/step (median after one warm-up) and peak GB."""
    from flashattn_tpu_torch.integrations import FlashMultiHeadDotProductAttention
    from flashattn_tpu_torch.models.transformer import adamw_init, adamw_update
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE

    B, N, F = x.shape
    wide = int(width["qkv_features"] // width["num_heads"] > 128)

    def build():
        m = FlashMultiHeadDotProductAttention(
            **width, impl="fused", device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(0))
        return m, None if rel0 is None else torch.nn.Parameter(rel0.clone())

    def params_of(m, rel):
        return {**dict(m.named_parameters()), **({} if rel is None else {"rel_bias": rel})}

    def loss_of(m, rel, plain=False):
        if plain:
            bias = torch.where(mask, 0.0, DEFAULT_MASK_VALUE)
            y = _plain_mhdpa(m, x, bias if rel is None else bias + rel)
        else:
            y = m(x, mask=mask, bias=rel)
        return ((y - target) ** 2 * valid[..., None]).sum() / (valid.sum() * F)

    def loss_and_grads(m, rel, plain=False):
        params = params_of(m, rel)
        for p in params.values():
            p.grad = None
        loss = loss_of(m, rel, plain)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in params.items()}

    model, rel = build()
    if next(model.parameters()).dtype != torch.float32:
        fail(f"f32 path A: the module's default dtype is {next(model.parameters()).dtype}")
    _reset_launches()
    lf, gf = loss_and_grads(model, rel)
    gate_launches = _launches()
    lp, gp = loss_and_grads(model, rel, plain=True)
    errs = {"loss": abs(lf - lp) / abs(lp), "gradients": _rel_l2(gf, gp),
            **({} if rel is None else {"rel_bias": _rel_l2({"r": gf["rel_bias"]},
                                                           {"r": gp["rel_bias"]})})}
    learned = "" if rel0 is None else f" + a trainable bias {list(rel0.shape)}"
    log(phase, f"{arm} arm: FlashMultiHeadDotProductAttention "
               f"({sum(p.numel() for p in params_of(model, rel).values()) / 1e6:.1f} M "
               f"params, {width['num_heads']} heads of "
               f"{width['qkv_features'] // width['num_heads']}, f32, impl fused) on x [{B}, "
               f"{N}, {F}], mask of lengths {ATTN_LENGTHS}{learned}: "
               f"loss fused {lf:.7f}, plain f32 {lp:.7f}; relative errors against "
               f"the plain f32 function (limit {F32_PATH_A_REL}): "
               + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    if not all(math.isfinite(e) and e <= F32_PATH_A_REL for e in errs.values()):
        fail(f"f32 path A {arm} gate: {errs} (limit {F32_PATH_A_REL})")
    del gf, gp
    dbias = int(rel0 is not None)
    want = _expect(K1=1, K1_bias=1, K1_f32=1, K1_f32_bias=1, K1_f32_d256=wide, split_bf16x3=2,
                   bias_bwd=1, bias_bwd_f32=1, bias_bwd_dbias=dbias, bwd_f32=1,
                   bwd_f32_d256=wide)
    if gate_launches != want:
        fail(f"f32 path A {arm}: the gate's step launched {gate_launches}, expected {want}")
    params = params_of(model, rel)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    losses, secs = [], []
    for _ in range(F32_PATH_A_STEPS):
        t0 = time.perf_counter()
        for p in params.values():
            p.grad = None
        loss = loss_of(model, rel)
        loss.backward()
        adamw_update({n: p.grad for n, p in params.items()}, opt, params)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = _launches()
    step_ms = statistics.median(secs[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = F32_PATH_A_STEPS
    want = _expect(K1=n, K1_bias=n, K1_f32=n, K1_f32_bias=n, K1_f32_d256=n * wide,
                   split_bf16x3=2 * n, bias_bwd=n, bias_bwd_f32=n, bias_bwd_dbias=n * dbias,
                   bwd_f32=n, bwd_f32_d256=n * wide)
    log(phase, f"{arm} arm: {n} AdamW steps, {step_ms:.2f} ms/step "
               f"({', '.join(f'{s * 1e3:.1f}' for s in secs)}; median after one "
               f"warm-up step), peak {peak:.2f} GB ({_card_name()}; "
               f"{_card_state()}); loss "
               f"{losses[0]:.6f} -> {losses[-1]:.6f}; launches {launches} (expected "
               f"K1 = K1 bias = K1 f32 = K1 f32 bias = bias bwd = bias bwd f32 = bwd "
               f"f32 = {n}{', K1 f32 d256 = bwd f32 d256 = ' + str(n) if wide else ''}, bias "
               f"bwd dbias = {n * dbias}, split bf16x3 = {2 * n}, no bf16 kernel)")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"f32 path A {arm}: losses {losses} not finite or not falling")
    if launches != want:
        fail(f"f32 path A {arm} launched {launches}, expected {want}")
    del model, rel, params, opt
    torch.cuda.empty_cache()
    return {"ms_per_step": step_ms, "peak_gb": peak, "launches": launches, "gate": errs}


def _f32_path_a_arms(width: dict, phase: str) -> dict:
    """f32 path A at ``width``: FlashMultiHeadDotProductAttention at its
    default float32 and impl "fused" on x [4, 2048, 2048] f32 with the
    key-padding mask of ATTN_LENGTHS, in two arms (_f32_path_a): the mask
    alone, and the mask plus a trainable [1, heads, N, N] f32 bias, whose
    gradient the f32 backward's dbias gives."""
    from flashattn_tpu_torch.integrations import make_attention_mask

    _f32_tf32_off()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    B, N, F = len(ATTN_LENGTHS), ATTN_SEQ, width["in_features"]
    x = torch.randn((B, N, F), generator=gen, device=DEVICE)
    target = 0.05 * torch.randn((B, N, F), generator=gen, device=DEVICE)
    lengths = torch.tensor(ATTN_LENGTHS, device=DEVICE)
    valid = torch.arange(N, device=DEVICE)[None] < lengths[:, None]
    mask = make_attention_mask(valid, valid, dtype=torch.bool)
    rel0 = torch.randn((1, width["num_heads"], N, N), generator=gen, device=DEVICE)
    kw = dict(width=width, phase=phase)
    return {"mask": _f32_path_a("mask", x, target, valid, mask, None, **kw),
            "learned": _f32_path_a("learned", x, target, valid, mask, rel0, **kw)}


def phase_f32_bias_train() -> dict:
    """f32 path A: FlashMultiHeadDotProductAttention with 16 heads of 128
    (ATTN_WIDTH), its two arms (_f32_path_a_arms)."""
    return _f32_path_a_arms(ATTN_WIDTH, "f32 bias_train")


# f32 at head dims 136-256: K1's f32 route's D 256 form (fwd_f32_wide_kernel,
# 64 Q rows a CTA) and the f32 backward's (bwd_f32_kernel<256, ...>, a
# cluster of two CTAs that split D), csrc/flash_fwd_f32.cu and
# csrc/flash_bwd_f32.cu, against the plain versions, TF32 off, q and k at
# GROW x unit scale: (tag, B, Hq, Hkv, Nq, Nk, D, kv_valid_len, options, ids
# kind as _seg_case_ids or None, bias dims as F32_BIAS_CASES' or None: no
# bias, K3 or the split route). D 256, 192 and 136 (in the 256 boxes: rank
# 1 of the backward's cluster then holds 8 real columns); causal, windows,
# every ids kind, the cap, offsets that leave dead rows, GQA, Nq 1, ragged
# kv_valid_len; with a bias every broadcast shape once and key padding with
# dead rows.
F32_WIDE_CASES = [
    ("causal GQA 8/4", 1, 8, 4, 257, 257, 256, 257, dict(causal=True), None, None),
    ("window (64, 32), Nq 300", 1, 4, 2, 300, 300, 192, 300, dict(window=(64, 32)), None,
     None),
    ("packed ids", 2, 4, 2, 256, 256, 136, 256, {}, "packed", None),
    ("cap 5, Nq 129, Nk 77", 1, 4, 2, 129, 77, 256, 77, dict(softcap=5.0), None, None),
    ("causal, random ids, cap 50", 2, 4, 2, 200, 200, 192, 200,
     dict(causal=True, softcap=50.0), "random", None),
    ("causal, q_off - kv_off 100, GQA 4/1", 1, 4, 1, 200, 300, 256, 300,
     dict(causal=True, q_offset=100, kv_offset=0), None, None),
    ("Nq 1, kv_valid_len 400 of 513, GQA 8/2", 2, 8, 2, 1, 513, 256, 400, {}, None, None),
    ("dead rows (ids no key carries)", 1, 4, 4, 300, 300, 136, 300, {}, "dead", None),
    ("ring kv past q (0, 256): dead rows", 1, 4, 2, 512, 256, 256, 256,
     dict(causal=True, q_offset=0, kv_offset=256), None, None),
    ("causal GQA 4/2, Nk 77, bias [B, H, Nq, Nk]", 2, 4, 2, 127, 77, 256, 77,
     dict(causal=True), None, (1, 1, 1)),
    ("kv_valid_len 150 of Nk 200, bias [1, 1, 1, Nk]", 2, 4, 4, 129, 200, 192, 150, {}, None,
     (0, 0, 0)),
    ("key padding, dead rows, bias [B, 1, N, N]", 2, 4, 4, 256, 256, 256, 256, {}, None,
     "padding"),
    ("window (64, 32), bias [1, H, Nq, Nk]", 1, 4, 2, 300, 300, 136, 300,
     dict(window=(64, 32)), None, (0, 1, 1)),
    ("random ids, bias [B, H, 1, Nk]", 2, 4, 2, 256, 256, 256, 256, {}, "random", (1, 1, 0)),
    ("causal, q_off - kv_off 100, GQA 4/1, bias [1, H, 1, Nk]", 1, 4, 1, 200, 300, 192, 300,
     dict(causal=True, q_offset=100, kv_offset=0), None, (0, 1, 0)),
    ("Nq 1, cap 5, bias [B, 1, 1, Nk]", 2, 4, 2, 1, 513, 256, 513, dict(softcap=5.0), None,
     (1, 0, 0)),
    ("window (40, 40), ids, q_off - kv_off 30, cap 5, bias [1, 1, Nq, Nk]", 2, 4, 2, 200, 260,
     256, 260, dict(window=(40, 40), q_offset=30, kv_offset=0, softcap=5.0), "tuple",
     (0, 0, 1)),
    ("causal GQA 8/1, Nq 129 < Nk 1000, kv_valid_len 900, bias [B, 1, Nq, Nk]", 1, 8, 1, 129,
     1000, 136, 900, dict(causal=True), None, (1, 0, 1)),
    # The two consumers' walk at D 256 (rank 0 folds the bias into its
    # partial S^T without the cap): every other Q tile skipped, one Q tile a
    # KV tile, KV tiles that no Q tile meets (with the cap: both ranks read
    # the bias).
    ("Nq 150, ids skipping every other Q tile, bias [B, H, Nq, Nk]", 2, 4, 2, 150, 160, 256,
     160, {}, "alternate", (1, 1, 1)),
    ("Nq 20, Nk 300: one Q tile a KV tile", 1, 4, 4, 20, 300, 256, 300, {}, None, None),
    ("causal Nq 100 < Nk 300, cap 5, bias [1, H, Nq, Nk]", 1, 4, 2, 100, 300, 192, 300,
     dict(causal=True, softcap=5.0), None, (0, 1, 1)),
]
# The bias cases that also run the backward without dbias.
F32_WIDE_NO_DBIAS = (10, 13, 18)


def f32_wide_instantiations() -> set:
    """The D 256 forms' instantiations, as instantiation_name names them:
    fwd_f32_wide_kernel<SEG, CAP, BIAS> and bwd_f32_kernel<256, SEG, CAP,
    BIAS>, 8 + 8."""
    def opts(sg, cp, b):
        return f"{' bias' if b else ''}{' segments' if sg else ''}{' softcap' if cp else ''}"

    flags = [(sg, cp, b) for sg in (0, 1) for cp in (0, 1) for b in (0, 1)]
    return ({f"K1 f32 d256{opts(*f)} fwd_f32_wide_kernel<{f[0]}, {f[1]}, {f[2]}>" for f in flags}
            | {f"bwd f32{opts(*f)} bwd_f32_kernel<256, {f[0]}, {f[1]}, {f[2]}>" for f in flags})


def _f32_flex_library_ms(q, k, v, do, cap: float) -> dict:
    """The library yardstick of a soft-capped f32 call, which no SDPA call
    computes: flex_attention compiled by torch.compile, causal, the cap as
    its score_mod, on the f32 inputs with TF32 off (Inductor then keeps its
    dots in f32), the forward (``do`` None) or the backward. A compile or
    launch that the backend refuses is logged and leaves library_ms null."""
    _f32_tf32_off()
    what = "backward" if do is not None else "forward"
    try:
        ms = flex_ms(q, k, v, scale=q.shape[-1] ** -0.5, do=do, score_mod=softcap_mod(cap),
                     mask_mod=band_mod(None))
    except Exception as e:  # noqa: BLE001 -- Inductor's and Triton's errors alike
        log("f32 wide", f"compiled flex_attention f32 {what} with the cap refused: "
                        f"{type(e).__name__}: {str(e)[:200]}")
        return {"library_ms": None, "library": f"none (compiled flex refused: {type(e).__name__})"}
    return {"library_ms": ms,
            "library": f"flex_attention compiled, f32 (TF32 off), causal, cap {cap} as score_mod"}


def _f32_wide_lm_timing() -> dict:
    """K1's f32 route's D 256 form and the f32 backward's at the attention of
    the f32 LM with heads of 256 (WIDE_SHAPE, B1 Hq8 Hkv4 N2048 D256, causal):
    the forward; the backward as K3, as the split route with the cap 50 (the
    forward capped too) and with 8 packed documents. Each held against its
    plain version on these inputs (TF32 off: O within FWD_TOL[f32], dQ / dK /
    dV within BWD_TOL[f32]), its error in its row; ms, the kernels' own
    device ms (kernels_ms), the plain version's ms, the bound (bytes at 3.35
    TB/s, the pairs' products at PEAK_F32_ACCURATE_FLOPS) and the faster of
    SDPA's two f32 backends on the same inputs (the documents as a boolean
    mask); with the cap, which SDPA does not take, compiled flex_attention
    with the cap as its score_mod (softcap_mod) and the causal block mask,
    TF32 off (_f32_flex_library_ms)."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.utils.testing import (
        BWD_TOL, FWD_TOL, check_close, grad_gate, make_qkv)

    B, Hq, Hkv, N, D = WIDE_SHAPE
    q, k, v = make_qkv(41, B, Hq, N, D, Hkv=Hkv, device=DEVICE)
    do = make_qkv(42, B, Hq, N, D, device=DEVICE)[0]
    ids = packed_ids(B, N)
    docs = flash_fwd.pair_mask(N, N, kv_valid_len=N, causal=True, segment_ids=(ids, ids),
                               device=DEVICE)
    variants = {  # row: (options, backward, its plain version, SDPA's arguments or None)
        "bwd": ({}, flash_bwd_fused.bwd, flash_bwd_fused.bwd_reference, dict(is_causal=True)),
        "bwd_cap": (dict(softcap=SOFTCAP), flash_bwd.split_bwd, flash_bwd.split_bwd_reference,
                    None),
        "bwd_ids": (dict(segment_ids=(ids, ids)), flash_bwd.split_bwd,
                    flash_bwd.split_bwd_reference, dict(attn_mask=docs))}
    rows = {}

    def timed(name, fn, plain, err, nbytes, matmuls, kw, lib_kw, lib_do):
        mask = dict(kv_valid_len=N, causal=True, segment_ids=kw.get("segment_ids"))
        row = {"max_abs_err": err, "ms": cuda_ms(fn, reps=5, trials=5),
               "kernel_ms": kernels_ms(fn, reps=5), "plain_ms": cuda_ms(plain, reps=1, trials=3),
               **bound(nbytes, pair_flops(q, k, matmuls=matmuls, **mask),
                       PEAK_F32_ACCURATE_FLOPS),
               **(_f32_flex_library_ms(q, k, v, lib_do, SOFTCAP) if lib_kw is None
                  else _f32_library_ms(q, k, v, lib_do, lib_kw))}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        lib = ("" if row["library_ms"] is None
               else f", {row['library']} {row['library_ms']:.4f} ms")
        log("f32 wide", f"{name} at B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal"
                        f"{' ' + ', '.join(kw) if kw else ''}: {row['ms']:.3f} ms (kernels alone "
                        f"{row['kernel_ms']:.3f} ms), plain {row['plain_ms']:.3f} ms, bound "
                        f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                        f"{row['bound_share']:.1%} of it){lib} ({_card_name()}; "
                        f"{_card_state()})")

    for name, (opts, bwd, bwd_ref, lib_kw) in variants.items():
        kw = dict(scale=D ** -0.5, causal=True, **opts)
        o, lse = flash_fwd.fwd(q, k, v, **kw)
        o_want, lse_want = flash_fwd.fwd_reference(q, k, v, **kw)
        ok_o, msg_o = check_close(o, o_want, FWD_TOL[torch.float32], "O")
        err_o = (o - o_want).abs().max().item()
        delta = (do * o).sum(-1)
        args = (q, k, v, do, lse, delta)
        got = bwd(*args, **kw)
        want = bwd_ref(*args, **kw)
        ok_g, why_g, err_g, _ = grad_gate(got, want, BWD_TOL[torch.float32])
        log("f32 wide", f"{name} inputs (the timed ones): K1 f32 d256 O max_abs_err {err_o:.3e}; "
                        f"the backward max_abs_err {err_g:.3e}")
        if not (ok_o and ok_g):
            fail(f"f32 at heads of 256 ({name}, the timed inputs): {msg_o}; {why_g}")
        del got, want, o_want, lse_want
        if name == "bwd":
            timed("fwd", lambda: flash_fwd.fwd(q, k, v, **kw),
                  lambda: flash_fwd.fwd_reference(q, k, v, **kw), err_o,
                  tensor_bytes(q, k, v, o, lse), 2, opts, lib_kw, None)
        timed(name, lambda: bwd(*args, **kw), lambda: bwd_ref(*args, **kw), err_g,
              tensor_bytes(q, k, v, do, lse, delta, q, q, q), 5, opts, lib_kw, do)
        del o, lse, args, delta
        torch.cuda.empty_cache()
    return rows


def phase_f32_wide_check() -> dict:
    """K1's f32 route's and the f32 backward's D 256 forms against their
    plain versions on every F32_WIDE_CASES entry, TF32 off: without a bias
    through _f32_case (O and LSE within FWD_TOL[f32], dQ / dK / dV within
    BWD_TOL[f32], dead rows and unreached keys exactly 0), with one through
    _f32_bias_case (and dbias within BWD_TOL[f32], exactly 0 on every
    dropped pair, read from NaN-filled memory), each with exactly one launch
    of each D 256 form and of the split; the 16 instantiations' SASS (HGMMA,
    UTMALDG, no HMMA); then both timed at the f32 LM's attention with heads
    of 256 (_f32_wide_lm_timing) and at path A's with heads of 256
    (_f32_bias_timing at H8 D256)."""
    from flashattn_tpu_torch.utils.testing import make_qkv

    _f32_tf32_off()
    errs = []
    for i, (tag, B, Hq, Hkv, Nq, Nk, D, nkv, kw, ids, dims) in enumerate(F32_WIDE_CASES):
        kw = dict(kw, kv_valid_len=nkv)
        if ids is not None:
            kw["segment_ids"] = _seg_case_ids(ids, 900 + i, B, Nq, Nk)
        tag = f"B{B} Hq{Hq} Hkv{Hkv} Nq{Nq} Nk{Nk} D{D}, {tag}"
        if dims is None:
            q, k, v = make_qkv(800 + 10 * i, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv, device=DEVICE)
            do = make_qkv(801 + 10 * i, B, Hq, Nq, D, device=DEVICE)[0]
            q, k, v, do = (_bnhd(x) for x in (GROW * q, GROW * k, v, do))
            errs.append(_f32_case(tag, q, k, v, do, kw))
        else:
            q, k, v, do, bias = _f32_bias_input(800 + 10 * i, B, Hq, Hkv, Nq, Nk, D, dims)
            errs.append(_f32_bias_case(tag, q, k, v, do, bias, kw,
                                       no_dbias=i in F32_WIDE_NO_DBIAS))
    worst = {n: max(e[n] for e in errs) for n in ("fwd_err", "bwd_err")}
    log("f32 wide", f"all {len(F32_WIDE_CASES)} cases: worst O {worst['fwd_err']:.3e}, worst "
                    f"dQ/dK/dV/dbias {worst['bwd_err']:.3e}")
    _tma_wgmma_sass("f32 wide", f32_wide_instantiations())
    rows = _f32_wide_timing()
    return {**rows, "cases_worst": worst}


def _f32_wide_timing() -> dict:
    """phase_f32_wide_check's timed rows: the LM's (_f32_wide_lm_timing) and
    path A's with heads of 256 (_f32_bias_timing at H8 D256)."""
    return {**_f32_wide_lm_timing(),
            **_f32_bias_timing(WIDE_ATTN_WIDTH["num_heads"], 256, "f32 wide")}


def phase_f32_wide_train() -> dict:
    """The two paths that f32 at heads of 256 opens. (a) The f32 LM with
    Gemma 2's heads of 256 (WIDE_LM_WIDTH, dtype float32: bench_lm's width, 8
    query and 4 KV heads of 256) in three variants -- unpacked at [1, 2049],
    with logit_softcap 50, packed (8 documents a row; steps at [2, 4097]) --
    each with the f32 LM's gates (_f32_lm_gates: fused vs xla, loss 1e-3,
    gradients 1e-3 relative L2) and F32_STEPS fused AdamW steps whose loss
    falls, with exact launches: K1's f32 route's D 256 form, then the f32
    backward's as K3 / as the split route, n_layers x F32_STEPS each, no bf16
    kernel. (b) f32 path A with heads of 256 (_f32_path_a_arms at
    WIDE_ATTN_WIDTH): the mask arm and the learned-bias arm (dbias), gated
    at F32_PATH_A_REL, the D 256 forms' BIAS families."""
    from flashattn_tpu_torch.models.transformer import TransformerConfig

    _f32_tf32_off()
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    vocab = WIDE_LM_WIDTH["vocab_size"]
    tokens = torch.randint(0, vocab, (1, LM_SEQ + 1), generator=gen, device=DEVICE)
    B, N = PACKED_SHAPE
    packed_tokens = torch.randint(0, vocab, (B, N + 1), generator=gen, device=DEVICE)
    n = WIDE_LM_WIDTH["n_layers"] * F32_STEPS
    f32 = dict(K1=n, K1_f32=n, K1_f32_d256=n, bwd_f32=n, bwd_f32_d256=n, split_bf16x3=2 * n)
    cfg = TransformerConfig(**WIDE_LM_WIDTH, dtype=torch.float32)
    variants = {
        "unpacked": (cfg, None, tokens, None, dict(**f32, K3=n)),
        "softcap": (dataclasses.replace(cfg, logit_softcap=SOFTCAP), None, tokens, None,
                    dict(**f32, K1_softcap=n, split_bwd=n)),
        "packed": (cfg, packed_ids(1, LM_SEQ + 1), packed_tokens, packed_ids(B, N + 1),
                   dict(**f32, split_bwd=n))}
    out = {}
    for tag, (c, gate_ids, step_tokens, step_ids, counts) in variants.items():
        _f32_lm_gates(c, tokens, gate_ids, f"heads of 256, {tag}")
        _reset_launches()
        step_s = _lm_steps(c, step_tokens, "fused", step_ids, phase="f32 wide train",
                           label=f"f32 fused, heads of 256, {tag}", steps=F32_STEPS, warmup=1)
        got = _launches()
        want = _expect(**counts)
        log("f32 wide train", f"{tag}: launches {got} (expected "
                              f"{', '.join(f'{k} {v}' for k, v in counts.items())}, no other) "
                              f"({_card_name()})")
        if got != want:
            fail(f"the f32 LM with heads of 256 ({tag}) launched {got}, expected {want}")
        out[tag] = {"launches": got, "ms_per_step": step_s * 1e3}
    out["path_a"] = _f32_path_a_arms(WIDE_ATTN_WIDTH, "f32 wide train")
    return out


# The composition fuzz's card arm (phase_fuzz): FUZZ_DRAWS draws of
# utils/testing.sample_composition from seeds FUZZ_SEED on, then draws from
# later seeds, up to FUZZ_MAX_SEEDS, only where one of FUZZ_ROUTES has not
# been reached yet (the routes predicted by the wrappers' own route rules; the
# launches then decide). A draw may be refused only under the labels still
# open (FUZZ_OPEN_LABELS); an f32 draw never (f32 takes every option at
# every head dim the sampler draws).
FUZZ_SEED = 3000
FUZZ_DRAWS = 40
FUZZ_MAX_SEEDS = 4000
FUZZ_OPEN_LABELS = ("K1 options",)
FUZZ_ROUTES = ("K1 dense", "K1 bias", "K1 bias d256", "K1 f32", "K1 f32 bias", "K1 f32 d256",
               "K1 decode", "K1 quant", "K3",
               "split route", "bias backward", "bias backward d256", "f32 backward",
               "f32 bias backward", "f32 backward d256")


def _fuzz_routes(launches: dict, f32: bool) -> set:
    """The FUZZ_ROUTES that a draw's launches (a _launches() difference) went
    through."""
    got = {"K1 dense": launches["K1 dense sm90"],
           "K1 bias": launches["K1 bias sm90"] - launches["K1 bias d256"],
           "K1 bias d256": launches["K1 bias d256"],
           "K1 f32": launches["K1 f32"] - launches["K1 f32 bias"],
           "K1 f32 bias": launches["K1 f32 bias"], "K1 f32 d256": launches["K1 f32 d256"],
           "K1 decode": launches["K1 decode"],
           "K1 quant": launches["K1 quant sm90"],
           "K3": launches["K3 sm90"], "split route": 0 if f32 else launches["split bwd"],
           "bias backward": (launches["bias bwd"] - launches["bias bwd f32"]
                             - launches["bias bwd d256"]),
           "bias backward d256": launches["bias bwd d256"],
           "f32 backward": launches["bwd f32"] - launches["bias bwd f32"],
           "f32 bias backward": launches["bias bwd f32"],
           "f32 backward d256": launches["bwd f32 d256"]}
    return {name for name, n in got.items() if n > 0}


def _fuzz_quant_arm(c: dict) -> bool:
    """Whether a draw also runs the forward-only quantized arm: bf16 without
    a softcap (quantized K/V take none)."""
    return c["dtype"] == torch.bfloat16 and c["softcap"] is None


def _fuzz_predicted(c: dict) -> set:
    """The FUZZ_ROUTES a draw should take, by the wrappers' route rules (no
    launch): the forward's, the backward's and the quantized arm's."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_fwd

    D = -(-c["D"] // 8) * 8
    f32 = c["dtype"] == torch.float32
    seg = c["seg"]
    bias = c["bias_shape"]
    if f32:
        fwd = "K1 f32 bias" if bias else "K1 f32"
    elif flash_fwd.decode_route(rows=c["Hq"] // c["Hkv"] * c["Nq"], causal=c["causal"],
                                segment_ids=seg, window=c["window"], head_dim=D):
        fwd = "K1 decode"
    elif bias:
        fwd = "K1 bias" if D <= flash_fwd.DENSE_MAX_HEAD_DIM else "K1 bias d256"
    else:
        fwd = "K1 dense"
    if bias:
        bwd = ("f32 bias backward" if f32 else "bias backward"
               if D <= flash_bwd.SM90_BWD_NARROW_MAX else "bias backward d256")
    elif seg is not None or c["softcap"] is not None:
        bwd = "f32 backward" if f32 else "split route"
    else:
        bwd = "f32 backward" if f32 else "K3"
    routes = {fwd, bwd}
    if f32 and D > flash_fwd.DENSE_MAX_HEAD_DIM:
        routes |= {"K1 f32 d256", "f32 backward d256"}
    if _fuzz_quant_arm(c):
        routes.add("K1 decode" if fwd == "K1 decode" else "K1 quant")
    return routes


def _fuzz_quant(seed: int, c: dict, q, k, v, bias, seg) -> set:
    """The draw's forward-only quantized arm: its K/V quantized by
    quantize_kv (int8 on even seeds, fp8 on odd) and its every option
    through flash_fwd.fwd, against the port's oracle on the dequantized K/V
    (FWD_TOL[bf16]); returns its routes."""
    from flashattn_tpu_torch.ops import flash_fwd, quant
    from flashattn_tpu_torch.ops.oracle import attention_reference
    from flashattn_tpu_torch.utils.testing import FWD_TOL, check_close

    dt = torch.int8 if seed % 2 == 0 else torch.float8_e4m3fn
    qkv = quant.quantize_kv(k, v, dt, allow_slow_fp8=True)
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["q_off"],
              kv_offset=c["kv_off"], bias=bias, segment_ids=seg)
    before = _launches()
    o, _ = flash_fwd.fwd(q, qkv.k_q, qkv.v_q, scale=q.shape[-1] ** -0.5, k_scale=qkv.k_scale,
                         v_scale=qkv.v_scale, **kw)
    torch.cuda.synchronize()
    now = _launches()
    kd, vd = quant.dequantize_kv(qkv, torch.float32)
    ok, msg = check_close(o, attention_reference(q.float(), kd, vd, **kw), FWD_TOL[q.dtype], "O")
    if not ok:
        fail(f"fuzz seed {seed} ({c}), {dt} K/V: {msg}")
    return _fuzz_routes({n: now[n] - before[n] for n in now}, False)


def _fuzz_draw(seed: int, c: dict) -> tuple[set, str | None, float]:
    """One draw through flash_attention on the card, forward and backward
    (dQ, dK, dV and, with a bias, dbias), against autograd through the port's
    oracle (ops/oracle.attention_reference) on f32 copies of the same values,
    TF32 off: O within FWD_TOL, the gradients within BWD_TOL, of the draw's
    dtype; a bf16 draw without a softcap also through its quantized arm
    (_fuzz_quant). Returns the routes it went through, the refusal's message
    if it raised NotImplementedError under an open label, and its largest
    error."""
    from flashattn_tpu_torch.ops.flash import flash_attention
    from flashattn_tpu_torch.ops.oracle import attention_reference
    from flashattn_tpu_torch.utils.testing import (
        BWD_TOL, FWD_TOL, check_close, composition_inputs, grad_gate)

    x = composition_inputs(c, seed)
    dt = c["dtype"]
    q, k, v, do = (torch.from_numpy(x[n]).to(DEVICE, dt) for n in ("q", "k", "v", "do"))
    bias = None if x["bias"] is None else torch.from_numpy(x["bias"]).to(DEVICE)
    seg = None if c["seg"] is None else tuple(torch.from_numpy(s).to(DEVICE) for s in c["seg"])
    kw = dict(causal=c["causal"], window=c["window"], logit_softcap=c["softcap"],
              q_offset=c["q_off"], kv_offset=c["kv_off"])
    bnhd = c["layout"] == "BNHD"
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    if bias is not None:
        leaves.append(bias.detach().requires_grad_(True))

    def lay(t):
        return t.transpose(1, 2) if bnhd else t

    before = _launches()
    try:
        o = lay(flash_attention(*(lay(t) for t in leaves[:3]),
                                bias=leaves[3] if bias is not None else None,
                                segment_ids=seg, layout=c["layout"], **kw))
        grads = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
    except NotImplementedError as e:
        now = _launches()
        msg = str(e)
        if dt == torch.float32 or not any(label in msg for label in FUZZ_OPEN_LABELS):
            fail(f"fuzz seed {seed} ({c}): refused outside the open labels: {msg}")
        return _fuzz_routes({n: now[n] - before[n] for n in now}, dt == torch.float32), msg, 0.0
    now = _launches()
    routes = _fuzz_routes({n: now[n] - before[n] for n in now}, dt == torch.float32)
    if _fuzz_quant_arm(c):
        routes |= _fuzz_quant(seed, c, q, k, v, bias, seg)
    ref = [t.detach().float().requires_grad_(True) for t in leaves]
    o_want = attention_reference(*ref[:3], bias=ref[3] if bias is not None else None,
                                 segment_ids=seg, **kw)
    want = torch.autograd.grad(o_want, ref, do.float())
    ok_o, msg_o = check_close(o, o_want.detach(), FWD_TOL[dt], "O")
    names = ("dq", "dk", "dv", "dbias")[:len(leaves)]
    ok_g, why_g, err_g, _ = grad_gate(grads, want, BWD_TOL[dt], names=names)
    if not (ok_o and ok_g):
        fail(f"fuzz seed {seed} ({c}): {msg_o}; {why_g}")
    return routes, None, max(err_g, (o.float() - o_want).abs().max().item())


def phase_fuzz() -> dict:
    """The composition fuzz's card arm: utils/testing.sample_composition's
    draws through flash_attention (_fuzz_draw), FUZZ_DRAWS of them and then,
    from later seeds, the draws that reach a route of FUZZ_ROUTES not yet
    reached; fails on any error, any refusal outside FUZZ_OPEN_LABELS (and
    any of an f32 draw), and a route of FUZZ_ROUTES no draw
    reached. Prints the refusals by label."""
    import numpy as np

    from flashattn_tpu_torch.utils.testing import sample_composition

    _f32_tf32_off()
    reached, refused, worst, ran = collections.Counter(), collections.Counter(), 0.0, 0
    seed = FUZZ_SEED
    while seed < FUZZ_SEED + FUZZ_MAX_SEEDS:
        c = sample_composition(np.random.default_rng(seed))
        missing = set(FUZZ_ROUTES) - set(reached)
        if seed >= FUZZ_SEED + FUZZ_DRAWS:
            if not missing:
                break
            if not _fuzz_predicted(c) & missing:
                seed += 1
                continue
        routes, msg, err = _fuzz_draw(seed, c)
        ran += 1
        reached.update(routes)
        worst = max(worst, err)
        if msg is not None:
            refused[next(label for label in FUZZ_OPEN_LABELS if label in msg)] += 1
        seed += 1
    missing = [r for r in FUZZ_ROUTES if r not in reached]
    log("fuzz", f"{ran} draws (seeds {FUZZ_SEED}-{seed - 1}): every route's draws "
                f"{dict(reached)}; refused under open labels {dict(refused) or 'none'}; worst "
                f"max_abs_err {worst:.3e}; routes never reached: {missing or 'none'}")
    if missing:
        fail(f"the fuzz reached no draw of {missing} in {FUZZ_MAX_SEEDS} seeds")
    torch.cuda.empty_cache()
    return {"draws": ran, "routes": dict(reached), "refused": dict(refused), "worst": worst}


# Head dims above 128 in the backward (csrc/bwd_sm90_wide.cuh): K3's and the
# split route's D 256 form against their plain versions on q, k grown by
# GROW, (tag, D, B, Hq, Hkv, Nq, Nk, kv_valid_len, causal, window, ids kind
# as _seg_case_ids, softcap, (q_offset, kv_offset)): D 256, 192 and 136 (run
# in the 256 box), ragged Nq and Nk with kv_valid_len below Nk, GQA 8/4 and
# 8/1, causal with Nq < Nk and Nq > Nk, windows, each ids kind, the cap, ids
# with the cap, and K3 with offsets that leave dead rows and unreached keys.
WIDE_BWD_CASES = [
    ("causal", 256, 1, 8, 4, 1024, 1024, None, True, None, None, None, None),
    ("ragged GQA 8/1", 256, 2, 8, 1, 127, 77, 70, False, None, None, None, None),
    ("causal Nq < Nk", 256, 1, 8, 4, 129, 1300, 1200, True, None, None, None, None),
    ("window", 192, 1, 8, 4, 1024, 1300, 1250, False, (64, 32), None, None, None),
    ("causal window", 136, 1, 8, 1, 1024, 1024, None, True, (200, -1), None, None, None),
    ("window dead rows", 256, 1, 8, 4, 1300, 1024, None, False, (64, -1), None, None, None),
    ("packed", 256, 2, 8, 4, 1024, 1024, None, True, None, "packed", None, None),
    ("random ids", 192, 2, 8, 4, 1024, 1024, None, True, None, "random", None, None),
    ("tuple ids", 136, 2, 8, 1, 129, 1300, 1200, False, None, "tuple", None, None),
    ("dead ids", 256, 1, 8, 4, 1024, 1024, None, False, None, "dead", None, None),
    ("softcap", 256, 1, 8, 4, 1024, 1024, None, True, None, None, 5.0, None),
    ("softcap ragged", 136, 2, 8, 1, 127, 77, 70, False, None, None, 5.0, None),
    ("ids + softcap", 256, 2, 8, 4, 1024, 1024, None, True, None, "random", 5.0, None),
    ("ids + softcap + window", 192, 1, 8, 4, 1024, 1024, None, True, (200, -1), "packed",
     SOFTCAP, None),
    ("offsets", 256, 1, 8, 4, 1024, 1024, None, True, None, None, None, (512, 1024)),
]
# The LM with heads of 256 (Gemma 2's attention geometry: 8 query and 4 KV
# heads of 256 in bench_lm's d_model 2048), its steps (the median of 3 after
# one) and its attention, where phase_wide_bwd_check times the kernels.
WIDE_LM_WIDTH = dict(LM_WIDTH, n_heads=8, n_kv_heads=4, d_head=256)
WIDE_STEPS = 4
# The D 256 LM's attention kernels in a profile, by a part of their names: K1's
# dense route's D 256 form, K3's and the split route's D 256 forms.
WIDE_ATTN_KERNELS = {"K1": ("fwd_dense_sm90_kernel",), "K3": ("bwd_sm90_kernel",),
                     "split": ("bwd_split_sm90_kernel",)}
WIDE_SHAPE = (1, 8, 4, LM_SEQ, 256)  # B, Hq, Hkv, N, D
# Its contiguous sharded step (phase_wide_train): layers, mesh (data, model,
# seq) and tokens.
WIDE_SHARDED_LAYERS = 2
WIDE_SHARDED_MESH = (1, 1, 4)
WIDE_SHARDED_SEQ = 4096


def _wide_bwd_case(tag: str, q, k, v, do, **kw) -> dict:
    """K3 (neither segment ids nor the cap in ``kw``) or the split route at a
    head dim above 128 -- one launch of its D 256 form -- against its plain
    version on f32 copies of the same bf16 inputs, with the LSE and Delta of
    the plain forward: dQ / dK / dV within BWD_TOL[bf16] and each within
    WINDOW_REL_L2 relative L2 (printed with max|ref|), dead rows' dQ and the
    dK / dV rows of keys that no live row reaches exactly 0. Returns the max
    error, the dead rows and the unreached keys."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
    from flashattn_tpu_torch.utils.testing import BWD_TOL, grad_gate

    f32 = [x.float() for x in (q, k, v, do)]
    o_want, lse = flash_fwd.fwd_reference(*f32[:3], **kw)
    delta = (f32[3] * o_want).sum(-1)
    del o_want
    args = (q, k, v, do, lse, delta)
    split = "softcap" in kw or "segment_ids" in kw
    before = _launches()
    if split:
        got = flash_bwd.split_bwd(*args, **kw)
        torch.cuda.synchronize()
        _routed(f"the split route's D 256 form at {tag}", before, split_bwd=1, split_bwd_d256=1)
        want = flash_bwd.split_bwd_reference(*f32, lse, delta, **kw)
    else:
        got = flash_bwd_fused.bwd(*args, **kw)
        torch.cuda.synchronize()
        _routed(f"K3's D 256 form at {tag}", before, K3=1, K3_sm90=1, K3_d256=1)
        want = flash_bwd_fused.bwd_reference(*f32, lse, delta, **kw)
    names = ("dq", "dk", "dv")
    g_tol = BWD_TOL[torch.bfloat16]
    ok, why, err, _ = grad_gate(got, want, g_tol, names=names)
    rel = {n: (_rel(a.float(), e), e.abs().max().item()) for n, a, e in zip(names, got, want)}
    live = lse > math.log(2.0) * DEFAULT_MASK_VALUE * 0.5
    Nq, Nk = q.shape[2], k.shape[2]
    keep = flash_fwd.pair_mask(
        Nq, Nk, kv_valid_len=kw.get("kv_valid_len", Nk), causal=kw.get("causal", False),
        segment_ids=kw.get("segment_ids"), device=q.device, window=kw.get("window"),
        q_offset=kw.get("q_offset", 0), kv_offset=kw.get("kv_offset", 0))
    reached = (keep & live[..., None]).any(-2)  # [B, Hq, Nk]: keys some live row attends
    dead_zero = bool((got[0][~live] == 0).all())
    unreached_zero = bool((got[1][~reached] == 0).all() and (got[2][~reached] == 0).all())
    n_dead, n_unreached = int((~live).sum()), int((~reached).sum())
    log("wide", f"{tag}: {'split route' if split else 'K3'} D 256 form dQ/dK/dV max_abs_err "
                f"{err:.3e} (budget BWD_TOL[bf16] atol {g_tol.atol} rtol {g_tol.rtol}); "
                f"relative L2 (limit {WINDOW_REL_L2}) / max|ref|: "
                + ", ".join(f"{n} {r:.2e} / {m:.3f}" for n, (r, m) in rel.items())
                + f"; dead rows {n_dead}, their dQ exactly 0: {dead_zero}; unreached "
                f"(head, key) rows {n_unreached}, their dK / dV exactly 0: {unreached_zero}")
    if not ok:
        fail(f"the D 256 backward disagrees with its plain version at {tag}: {why}")
    if not all(r <= WINDOW_REL_L2 for r, _ in rel.values()):
        fail(f"the D 256 backward: relative L2 error above {WINDOW_REL_L2} at {tag}: {rel}")
    if not dead_zero:
        fail(f"the D 256 backward: dead rows' dQ not exactly 0 at {tag}")
    if not unreached_zero:
        fail(f"the D 256 backward: unreached keys' dK / dV not exactly 0 at {tag}")
    del got, want, f32
    torch.cuda.empty_cache()
    return {"err": err, "dead": n_dead, "unreached": n_unreached}


def _sdpa_backends_ms(q, k, v, *, do=None, call: str = "is_causal=True", **kw) -> dict:
    """SDPA on these inputs at its own choice of backend and at each fused
    backend that takes them (flash, memory-efficient, cuDNN; GQA by
    ``enable_gqa``, or on K / V expanded to the query heads where a backend
    refuses it), the forward or, with ``do``, the backward: the times by
    backend (logged), and the fastest fused backend's ms and name as
    ``library_ms`` / ``library_call`` (``call`` names the arguments). Unless
    YARDSTICKS, SDPA at its own choice of backend alone."""
    from torch.nn.attention import SDPBackend

    t0 = time.perf_counter()
    what = "backward" if do is not None else "forward"
    group = q.shape[1] // k.shape[1]
    times, device = {}, {}
    backends = (("its own choice", None), ("flash", SDPBackend.FLASH_ATTENTION),
                ("memory-efficient", SDPBackend.EFFICIENT_ATTENTION),
                ("cuDNN", SDPBackend.CUDNN_ATTENTION))
    for name, backend in backends if YARDSTICKS else backends[:1]:
        try:
            times[name] = sdpa_ms(q, k, v, do=do, backend=backend, **kw)
            device[name] = sdpa_ms(q, k, v, do=do, backend=backend, device=True, **kw)
        except RuntimeError:
            kx, vx = (x.repeat_interleave(group, 1) for x in (k, v))
            expanded = f"{name}, K / V expanded"
            try:
                times[expanded] = sdpa_ms(q, kx, vx, do=do, backend=backend, **kw)
                device[expanded] = sdpa_ms(q, kx, vx, do=do, backend=backend, device=True, **kw)
            except RuntimeError as e:  # the backend takes neither form
                log("wide", f"SDPA's {name} backend refused the {what}: {str(e)[:160]}")
            del kx, vx
    log("wide", f"SDPA {what} by backend, the call's CUDA-event ms / its kernels' device ms: "
                + ", ".join(f"{n} {t:.4f} / {device[n]:.4f}" for n, t in times.items()))
    fused = {n: t for n, t in times.items() if n != "its own choice"} or times
    name = min(fused, key=fused.get)
    if YARDSTICKS:
        YARDSTICK_SECONDS["SDPA backends"] += time.perf_counter() - t0
    return {"library_ms": fused[name],
            "library_call": f"the {what} of scaled_dot_product_attention({call}), "
                            f"{name} backend",
            "library_by_backend": times, "library_device_ms_by_backend": device}


def _wide_timing() -> dict:
    """K3's and the split route's D 256 forms (the cap; packed ids) and K1's
    dense route's at the D 256 LM's attention, B1 Hq8 Hkv4 N2048 D256 causal,
    on unit-scale bf16 views of [B, N, H, D] (the model's layout): each one
    launch on its route, held against its plain version on the timed inputs
    (O within FWD_TOL[bf16], dQ / dK / dV within BWD_TOL[bf16], each within
    WINDOW_REL_L2 relative L2; a miss fails), its median CUDA-event time
    beside the plain version's, its bound (pair_flops over the attended
    pairs; the bytes of the inputs and of the outputs as the function returns
    them: O, dQ, dK / dV in the input dtype, dK / dV at Hkv heads) and one
    library call's: SDPA (forward, backward; each fused backend timed,
    _sdpa_backends_ms), flex_attention's backward with the cap or the
    documents. Each row also gives its kernels' device time alone
    (``kernel_ms``, kernels_ms; the ids' call computes their tile ranges
    first), and SDPA's rows each backend's (``library_device_ms_by_backend``)."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.utils import native
    from flashattn_tpu_torch.utils.testing import (
        BWD_TOL, FWD_TOL, check_close, grad_gate, make_qkv)

    B, Hq, Hkv, N, D = WIDE_SHAPE
    q, k, v = (_bnhd(x) for x in make_qkv(1500, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                           device=DEVICE))
    do = _bnhd(make_qkv(1501, B, Hq, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    scale = D ** -0.5
    ids = packed_ids(B, N + 1)[:, :N]
    stats = 4 * B * Hq * N
    res = {}
    f32 = [x.float() for x in (q, k, v, do)]
    # K1's dense route's D 256 form.
    before = _launches()
    o = flash_fwd.fwd(q, k, v, scale=scale, causal=True)[0]
    torch.cuda.synchronize()
    _routed("K1 at the D 256 LM's attention", before, K1=1, K1_dense_sm90=1, K1_dense_d256=1)
    o_want = flash_fwd.fwd_reference(*f32[:3], scale=scale, causal=True)[0]
    ok_o, msg_o = check_close(o, o_want, FWD_TOL[torch.bfloat16], "O")
    rel_o = _rel(o.float(), o_want)
    log("wide", f"K1 at B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal: O {msg_o}; relative L2 "
                f"{rel_o:.2e} (limit {WINDOW_REL_L2})")
    if not ok_o or not rel_o <= WINDOW_REL_L2:
        fail(f"K1 at the D 256 LM's attention disagrees with its plain version: {msg_o}; "
             f"relative L2 {rel_o}")
    k1 = lambda: flash_fwd.fwd(q, k, v, scale=scale, causal=True)  # noqa: E731
    # The host's side of the call: flash_fwd.fwd whole, and its C entry alone
    # (ctypes, the three tensor maps, the launch) on the same operands, the
    # outputs allocated once; the C entry's launches here are not counted.
    lib, o_c = native.kernels(), torch.empty_like(q)
    lse_c = torch.empty((B, Hq, N), dtype=torch.float32, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    c_entry = lambda: flash_fwd._launch_dense_sm90(  # noqa: E731
        lib, q, k, v, o_c, lse_c, None, scale=scale, kv_valid_len=N, causal=True, window=None,
        softcap=None, stream=stream)
    host = {"host_ms": host_ms(k1), "c_entry_host_ms": host_ms(c_entry)}
    for name, calls, ms in host_profile(k1):
        log("wide", f"K1 D 256 host profile: {name}: {calls} calls, {ms:.4f} ms a call")
    del o_c, lse_c
    res["k1"] = {"max_abs_err": (o.float() - o_want).abs().max().item(),
                 "ms": cuda_ms(k1), "kernel_ms": kernels_ms(k1), **host,
                 "plain_ms": cuda_ms(lambda: flash_fwd.fwd_reference(
                     q, k, v, scale=scale, causal=True), reps=3),
                 **bound(tensor_bytes(q, k, v, q) + stats,
                         pair_flops(q, k, matmuls=2, kv_valid_len=N, causal=True,
                                    segment_ids=None)),
                 **_sdpa_backends_ms(q, k, v, is_causal=True)}
    del o, o_want
    cases = {"k3": ({}, "K3", dict(K3=1, K3_sm90=1, K3_d256=1)),
             "split_cap": (dict(softcap=SOFTCAP), "split", dict(split_bwd=1, split_bwd_d256=1)),
             "split_seg": (dict(segment_ids=(ids, ids)), "split",
                           dict(split_bwd=1, split_bwd_d256=1))}
    names, g_tol = ("dq", "dk", "dv"), BWD_TOL[torch.bfloat16]
    for key, (opt, route, want_launches) in cases.items():
        kw = dict(scale=scale, causal=True, **opt)
        o32, lse = flash_fwd.fwd_reference(*f32[:3], **kw)
        delta = (f32[3] * o32).sum(-1)
        del o32
        args = (q, k, v, do, lse, delta)
        kernel, plain = ((flash_bwd_fused.bwd, flash_bwd_fused.bwd_reference) if route == "K3"
                         else (flash_bwd.split_bwd, flash_bwd.split_bwd_reference))
        before = _launches()
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        _routed(f"{key} at the D 256 LM's attention", before, **want_launches)
        want = plain(*f32, lse, delta, **kw)
        ok, why, err, _ = grad_gate(got, want, g_tol, names=names)
        rel = {n: _rel(a.float(), e) for n, a, e in zip(names, got, want)}
        log("wide", f"{key} at B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal: dQ/dK/dV max_abs_err "
                    f"{err:.3e} (budget BWD_TOL[bf16] atol {g_tol.atol} rtol {g_tol.rtol}); "
                    f"relative L2 (limit {WINDOW_REL_L2}) "
                    + ", ".join(f"{n} {r:.2e}" for n, r in rel.items()))
        if not ok:
            fail(f"{key} at the D 256 LM's attention disagrees with its plain version: {why}")
        if not all(r <= WINDOW_REL_L2 for r in rel.values()):
            fail(f"{key} at the D 256 LM's attention: relative L2 above {WINDOW_REL_L2}: {rel}")
        del got, want
        mask = dict(kv_valid_len=N, causal=True, segment_ids=opt.get("segment_ids"))
        # In: q, k, v, dO, LSE, Delta (and the ids); out: dQ, dK, dV as the
        # function returns them (the input dtype; dK / dV at Hkv heads).
        row = {"max_abs_err": err, "ms": cuda_ms(lambda: kernel(*args, **kw)),
               "plain_ms": cuda_ms(lambda: plain(*args, **kw), reps=3),
               **bound(tensor_bytes(q, k, v, do, lse, delta) + tensor_bytes(q, k, v)
                       + (tensor_bytes(ids, ids) if "segment_ids" in opt else 0),
                       pair_flops(q, k, matmuls=5, **mask))}
        # The kernel's device time alone: the ids' call computes their tile
        # ranges first.
        row["kernel_ms"] = kernels_ms(lambda: kernel(*args, **kw))
        if key == "k3":
            row.update(_sdpa_backends_ms(q, k, v, do=do, is_causal=True))
        elif key == "split_cap":
            row.update(library_ms=flex_ms(q, k, v, scale=scale, do=do,
                                          score_mod=softcap_mod(SOFTCAP), mask_mod=band_mod(None)),
                       library_call="the backward of flex_attention (torch.compile) with the cap "
                                    "and the causal mask")
        else:
            row.update(library_ms=flex_ms(q, k, v, scale=scale, do=do,
                                          mask_mod=band_mod(None, ids)),
                       library_call="the backward of flex_attention (torch.compile) with the "
                                    "causal document mask")
        res[key] = row
        torch.cuda.empty_cache()
    for key, row in res.items():
        alone = f" (the kernel alone {row['kernel_ms']:.4f})"
        if "host_ms" in row:
            alone += (f", host {row['host_ms']:.4f} a call (its C entry alone "
                      f"{row['c_entry_host_ms']:.4f})")
        log("wide", f"{key} at B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} causal bf16: {row['ms']:.4f} ms"
                    f"{alone}, plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
                    f"{row['bound_by']}, library {ms_text(row['library_ms'])} "
                    f"({row['library_call']}); "
                    f"max_abs_err {row['max_abs_err']:.3e} (median CUDA-event time)")
    return res


def phase_wide_bwd_check() -> dict:
    """K3's and the split route's D 256 form (csrc/bwd_sm90_wide.cuh) against
    their plain versions (_wide_bwd_case) on WIDE_BWD_CASES and, backward
    only, on WIDE_CASES' shapes without a bias (D 160, the cap with a window
    and / or ids); WIDE_CASES with a bias through K1 and the bias route's D
    256 form with dbias (_fwd_bwd_check); then the times at the D 256 LM's
    attention (_wide_timing) and, after those numeric gates, the four D 256
    instantiations' SASS (_tma_wgmma_sass: HGMMA, UTMALDG, no HMMA)."""
    from flashattn_tpu_torch.utils.testing import make_qkv

    cases = list(WIDE_BWD_CASES) + [
        (f"D {WIDE_D} {name}", WIDE_D, 1, 8, 4, nq, nk, None, causal, window, ids, cap, None)
        for name, nq, nk, causal, window, ids, biased, cap, _ in WIDE_CASES if not biased]
    dead = unreached = 0
    for i, (name, D, B, Hq, Hkv, Nq, Nk, kvl, causal, window, ids, cap, offsets) in enumerate(
            cases):
        q, k, v = _grown(1200 + i, B, Hq, Nq, D, Nk, Hkv)
        do = _bnhd(make_qkv(1300 + i, B, Hq, Nq, D, dtype=torch.bfloat16, device=DEVICE)[0])
        kw = dict(scale=D ** -0.5, causal=causal)
        if kvl is not None:
            kw["kv_valid_len"] = kvl
        if window is not None:
            kw["window"] = window
        if ids is not None:
            kw["segment_ids"] = _seg_case_ids(ids, 1400 + i, B, Nq, Nk)
        if cap is not None:
            kw["softcap"] = cap
        if offsets is not None:
            kw["q_offset"], kw["kv_offset"] = offsets
        out = _wide_bwd_case(
            f"{name}: D{D} B{B} Hq{Hq} Hkv{Hkv} Nq{Nq} Nk{Nk}"
            f"{'' if kvl is None else f' kv_valid_len {kvl}'}{' causal' if causal else ''}"
            f"{'' if window is None else f', window {window}'}"
            f"{'' if ids is None else f', {ids} ids'}{'' if cap is None else f', softcap {cap}'}"
            f"{'' if offsets is None else f', q / kv offsets {offsets}'}", q, k, v, do, **kw)
        dead += out["dead"]
        unreached += out["unreached"]
        del q, k, v, do, kw
    if not dead or not unreached:
        fail(f"the D 256 cases hold {dead} dead rows and {unreached} unreached keys: the "
             "exact-zero gates were not exercised")
    for i, (name, nq, *_, biased, _cap, _dead) in enumerate(WIDE_CASES):
        if biased:
            q, k, v, kw, tag = _wide_case(i)
            do = _bnhd(make_qkv(1350 + i, 1, 8, nq, WIDE_D, dtype=torch.bfloat16,
                                device=DEVICE)[0])
            _fwd_bwd_check(tag, q, k, v, do, phase="wide", want_dbias=True, **kw)
            del q, k, v, do, kw
    res = _wide_timing()
    _tma_wgmma_sass("wide", {"K3 sm90 bwd_sm90_kernel<256>"} | {
        f"K5 + K6 split sm90{' segments' if sg else ''}{' softcap' if cp else ''} "
        f"bwd_split_sm90_kernel<256, {sg}, {cp}>" for sg, cp in ((1, 0), (0, 1), (1, 1))})
    return res


def phase_wide_train() -> dict:
    """The LM with heads of 256 (WIDE_LM_WIDTH: bench_lm's width, 8 query and 4
    KV heads of 256, bf16) in three variants -- unpacked at [1, 2049]; with
    logit_softcap 50 (Gemma 2's cap); packed, 8 documents a row -- each with
    the fused-vs-xla gates of _lm_gates (the packed one at [1, 2049], 1.5x
    the bf16 floor), then WIDE_STEPS fused AdamW steps (packed at [2, 4097])
    and one more under torch.profiler (its wall and kernel time, the
    attention kernels' share, the card's clocks after it), with exact
    launches: K1's dense route's D 256 form and K3's, K1 capped and the split
    route's D 256 form, K1 with ids and the split route's D 256 form, n_layers
    x (WIDE_STEPS + 1) each and no other; then one contiguous sharded step
    of the LM (_sharded_lm_wide). Returns the launch counts, ms/step and the
    profiled step's times per variant, and the sharded step's gates."""
    from flashattn_tpu_torch.models.transformer import TransformerConfig

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    tokens = torch.randint(0, WIDE_LM_WIDTH["vocab_size"], (1, LM_SEQ + 1), generator=gen,
                           device=DEVICE)
    B, N = PACKED_SHAPE
    packed_tokens = torch.randint(0, WIDE_LM_WIDTH["vocab_size"], (B, N + 1), generator=gen,
                                  device=DEVICE)
    n = WIDE_LM_WIDTH["n_layers"] * (WIDE_STEPS + 1)  # the timed steps and the profiled one
    k1 = dict(K1=n, K1_dense_sm90=n, K1_dense_d256=n)
    variants = {
        "unpacked": (TransformerConfig(**WIDE_LM_WIDTH), None, tokens, None,
                     dict(**k1, K3=n, K3_sm90=n, K3_d256=n)),
        "softcap": (TransformerConfig(**WIDE_LM_WIDTH, logit_softcap=SOFTCAP), None, tokens,
                    None, dict(**k1, K1_softcap=n, split_bwd=n, split_bwd_d256=n)),
        "packed": (TransformerConfig(**WIDE_LM_WIDTH), packed_ids(1, LM_SEQ + 1), packed_tokens,
                   packed_ids(B, N + 1), dict(**k1, split_bwd=n, split_bwd_d256=n))}
    out = {}
    for tag, (cfg, gate_ids, step_tokens, step_ids, counts) in variants.items():
        _lm_gates(cfg, tokens, gate_ids, None, "wide train")
        _reset_launches()
        prof = {}
        step_s = _lm_steps(cfg, step_tokens, "fused", step_ids, phase="wide train",
                           label=f"fused, heads of 256, {tag}", steps=WIDE_STEPS, warmup=1,
                           profile=prof)
        got = _launches()
        want = _expect(**counts)
        log("wide train", f"{tag}: launches {got} (expected "
                          f"{', '.join(f'{k} {v}' for k, v in counts.items())}, no other)")
        if got != want:
            fail(f"the D 256 LM's steps ({tag}) launched {got}, expected {want}")
        attn = {n: sum(t for key, t in prof["kernels_ms"].items() if any(m in key for m in ms))
                for n, ms in WIDE_ATTN_KERNELS.items()}
        top = sorted(prof["kernels_ms"].items(), key=lambda kv: -kv[1])[:5]
        kernel_time = (f"{prof['device_ms']:.2f} ms of kernel time (the device idles "
                       f"{100 * (1.0 - prof['device_ms'] / prof['wall_ms']):.1f}%)"
                       if prof["device_ms"] > 0 else
                       "kernel time not measured (the profiler saw no device time)")
        log("wide train", f"{tag}: one profiled step, {prof['wall_ms']:.2f} ms wall, "
                          f"{kernel_time}; attention "
                          + ", ".join(f"{n} {t:.2f} ms" for n, t in attn.items())
                          + "; most time in: "
                          + "; ".join(f"{n[:60]} {t:.2f} ms" for n, t in top)
                          + f"; card after it (SM clock, max SM clock, power, temperature): "
                          f"{prof['card']}")
        out[tag] = {"launches": got, "ms_per_step": step_s * 1e3,
                    "profiled_wall_ms": prof["wall_ms"], "profiled_device_ms": prof["device_ms"],
                    "profiled_attention_ms": attn}
    out["sharded"] = _sharded_lm_wide()
    return out


def _sharded_lm_wide() -> dict:
    """The LM with heads of 256 (WIDE_LM_WIDTH) at WIDE_SHARDED_LAYERS layers
    through make_sharded_train_step on a WIDE_SHARDED_MESH VirtualMesh at [1,
    WIDE_SHARDED_SEQ] tokens, contiguous: one lr=0 step with the counters
    reset just before -- its loss within SHARDED_LOSS_TOL of the
    single-device lm_loss, exact launches (layers x the 10 live chunk pairs
    of 4 seq ranks on K1's dense route's D 256 form and K3's, every pair off
    the diagonal with q / kv offsets) -- its gradients of
    SHARDED_GRAD_LEAVES (step.loss_and_grads) within SHARDED_GRAD_FLOOR_X
    times the single-device bf16 step's distance from an f32 copy of the
    model (_lm_truth), and the median of SHARDED_TIMED timed steps."""
    from flashattn_tpu_torch.models import transformer as T
    from flashattn_tpu_torch.parallel import make_mesh

    cfg = T.TransformerConfig(**dict(WIDE_LM_WIDTH, n_layers=WIDE_SHARDED_LAYERS))
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    model = T.init_transformer(cfg, gen, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, (1, WIDE_SHARDED_SEQ), generator=gen,
                           device=DEVICE)
    ref, truth, floor = (d["contiguous"] for d in _lm_truth(model, cfg, tokens,
                                                            {"contiguous": None}))
    mesh = make_mesh(*WIDE_SHARDED_MESH)
    data, tp, sp = WIDE_SHARDED_MESH
    pairs = cfg.n_layers * data * tp * sp * (sp + 1) // 2
    want = dict(K1=pairs, K1_dense_sm90=pairs, K1_dense_d256=pairs, K3=pairs, K3_sm90=pairs,
                K3_d256=pairs)
    shards = T.shard_params(model, mesh)
    opt = [T.adamw_init(p) for p in shards]
    step, specs, _ = T.make_sharded_train_step(mesh, cfg, lr=0.0)
    _reset_launches()
    _, _, got = step(shards, opt, tokens)
    torch.cuda.synchronize()
    counts = _launches()
    got = got.item()
    _, grads = step.loss_and_grads(shards, tokens)
    rel = _grad_rel_l2(mesh, grads, truth, specs)
    del grads
    secs = []
    for _ in range(SHARDED_TIMED):
        t0 = time.perf_counter()
        step(shards, opt, tokens)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log("wide train", f"sharded step, {cfg.n_layers} layers of the LM with heads of 256 on a "
                      f"(data {data}, model {tp}, seq {sp}) VirtualMesh, {list(tokens.shape)} "
                      f"tokens, contiguous: lr=0 loss {got:.5f}, single-device lm_loss {ref:.5f}, "
                      f"|diff| {abs(got - ref):.2e} (limit {SHARDED_LOSS_TOL}); gradients' "
                      "relative L2 against the f32 model "
                      + ", ".join(f"{n} {e:.3e} (bf16 floor {floor[n]:.3e})"
                                  for n, e in rel.items())
                      + f" (limit {SHARDED_GRAD_FLOOR_X} x floor); "
                      f"{statistics.median(secs) * 1e3:.1f} ms/step (median of "
                      f"{', '.join(f'{x * 1e3:.1f}' for x in secs)}); launches "
                      f"{ {n: c for n, c in counts.items() if c} } (expected {want})")
    if counts != _expect(**want):
        fail(f"the D 256 sharded step launched {counts}, expected {want} and no other")
    if not abs(got - ref) <= SHARDED_LOSS_TOL:
        fail(f"the D 256 sharded step's loss {got} vs single-device {ref}")
    if not all(e <= SHARDED_GRAD_FLOOR_X * floor[n] for n, e in rel.items()):
        fail(f"the D 256 sharded step's gradients vs the f32 model: {rel}, above "
             f"{SHARDED_GRAD_FLOOR_X} x the bf16 floor {floor}")
    del shards, opt, model
    torch.cuda.empty_cache()
    return {"counts": counts, "loss": got, "single_device_loss": ref, "grad_rel_l2": rel,
            "grad_floor": floor, "ms": statistics.median(secs) * 1e3}


# Head dims above 128 with a bias (csrc/fwd_sm90_tile.cuh's D 256 bias slot,
# csrc/bwd_sm90_wide.cuh's BIAS family): K1's and K5 + K6's bias routes'
# D 256 forms against their plain versions on q, k grown by GROW, BAND_CASES'
# kind of cases at D 256, 192, 160 and 136: (tag, D, B, Hq, Hkv, Nq, Nk,
# kv_valid_len, causal, window, ids ("docs": _band_ids, one document no key
# carries), (q_offset, kv_offset), bias (_band_bias' "mask" / "learned" kind,
# or which of its (batch, head, row) dims a normal bias has), softcap, dbias,
# has dead rows).
WIDE_BIAS_CASES = [
    ("mask arm", 256, 2, 8, 8, 1024, 1024, None, False, None, None, (0, 0), "mask", None,
     False, True),
    ("learned arm", 256, 2, 8, 8, 1024, 1024, None, False, None, None, (0, 0), "learned", None,
     True, True),
    ("mask arm, softcap 50", 256, 2, 8, 8, 1024, 1024, None, False, None, None, (0, 0), "mask",
     SOFTCAP, False, True),
    ("causal GQA 8/2, [B, 1, 1, Nk] bias", 256, 2, 8, 2, 1024, 1024, None, True, None, None,
     (0, 0), (1, 0, 0), None, True, False),
    ("window, learned arm, softcap 50", 160, 2, 8, 4, 1024, 1024, None, False, BAND_WINDOW, None,
     (0, 0), "learned", SOFTCAP, True, True),
    ("causal window Nq > Nk, [1, H, N, N], cap 5", 136, 1, 8, 4, 1300, 1024, None, True,
     (200, -1), None, (0, 0), (0, 1, 1), 5.0, True, True),
    ("8 documents, causal, full bias", 256, 2, 8, 4, 1024, 1024, None, True, None, "docs",
     (0, 0), (1, 1, 1), None, True, True),
    ("causal, q_off - kv_off = 2048", 256, 1, 8, 4, 1024, 1024, None, True, None, None,
     (2048, 0), (1, 1, 1), None, True, False),
    ("causal, q_off - kv_off = -64, [1, 1, N, N]", 192, 1, 8, 4, 1024, 1024, None, True, None,
     None, (0, 64), (0, 0, 1), None, True, True),
    ("ragged Nq 1300, kv tail 900 of 1000, [B, 1, N, N]", 256, 2, 8, 1, 1300, 1000, 900, False,
     None, None, (0, 0), (1, 0, 1), None, True, False),
    ("Nq 1", 256, 2, 8, 4, 1, 1000, None, False, None, None, (0, 0), (1, 1, 1), None, True,
     False),
    ("ids + window + offsets + cap 5", 256, 1, 8, 4, 1024, 1024, None, True, (300, -1), "docs",
     (128, 0), (1, 1, 1), 5.0, True, True),
]
# Path A with heads of 256: Gemma 2B's width of 2048 in its 8 query heads of
# 256 (the module has no GQA, so K / V take 8 heads too).
WIDE_ATTN_WIDTH = dict(num_heads=8, in_features=2048, qkv_features=2048)


def _wide_bias(kind, seed: int, B: int, Hq: int, Nq: int, Nk: int) -> torch.Tensor:
    """A WIDE_BIAS_CASES bias (f32): _band_bias' "mask" / "learned", or a
    normal bias with the (batch, head, row) dims that ``kind`` flags."""
    if isinstance(kind, str):
        return _band_bias(kind, seed, B, Hq, Nq, Nk)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    shape = tuple(n if f else 1 for n, f in zip((B, Hq, Nq), kind)) + (Nk,)
    return torch.randn(shape, generator=gen, device=DEVICE)


def wide_bias_instantiations() -> set:
    """The D 256 forms of the bias routes, as instantiation_name names them:
    fwd_bias_sm90_kernel<256, SEG, CAP> and bwd_bias_wide_kernel<SEG, CAP>."""
    names = set()
    for sg in (0, 1):
        for cp in (0, 1):
            tag = f"{' segments' if sg else ''}{' softcap' if cp else ''}"
            names |= {f"K1 bias sm90{tag} fwd_bias_sm90_kernel<256, {sg}, {cp}>",
                      f"bias bwd sm90 d256{tag} bwd_bias_wide_kernel<{sg}, {cp}>"}
    return names


def _wide_bias_timing() -> dict:
    """K1's and K5 + K6's bias routes' D 256 forms at the shape of path A with
    heads of 256 (B4 H8 N2048 D256, bf16, q and k at GROW) on both arms'
    biases (the mask arm's [4, 1, N, N] key padding without dbias, the
    learned arm's [4, 8, N, N] with), each first held against its plain
    version (_fwd_bwd_check). Each row: its time (median CUDA-event), its
    plain version's, its bound (every pair of the N x N tile: the kernels
    compute the padding's pairs too; the bias read once, dbias written
    once) and the library's, the faster of SDPA with the bias as
    ``attn_mask`` (each fused backend that takes it, named; with dbias a bf16
    copy of the bias that requires grad, SDPA's dbias) and flex_attention
    compiled by torch.compile with the bias as ``score_mod`` (its backward
    has no dbias: the bias it reads does not require grad)."""
    from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
    from flashattn_tpu_torch.utils.testing import make_qkv

    B, N = len(ATTN_LENGTHS), ATTN_SEQ
    H = WIDE_ATTN_WIDTH["num_heads"]
    D = WIDE_ATTN_WIDTH["qkv_features"] // H
    pad = _padding_bias(ATTN_LENGTHS, N)
    gen = torch.Generator(device=DEVICE).manual_seed(1690)
    rel = torch.randn((1, H, N, N), generator=gen, device=DEVICE)
    q, k, v = _grown(1691, B, H, N, D, N, H)
    do = _bnhd(make_qkv(1692, B, H, N, D, dtype=torch.bfloat16, device=DEVICE)[0])
    stats = 4 * B * H * N
    flops = pair_flops(q, k, matmuls=1, kv_valid_len=N, causal=False, segment_ids=None)
    res = {}
    for name, bias, dbias in (("mask", pad, False), ("learned", pad + rel, True)):
        kw = dict(scale=D ** -0.5, bias=bias)
        out = _fwd_bwd_check(f"path A's D 256 shape B{B} H{H} N{N} D{D}, {name} arm's bias "
                             f"{list(bias.shape)}{', dbias' if dbias else ''}", q, k, v, do,
                             phase="wide bias", want_dbias=dbias, **kw)
        args = out["args"]
        try:
            flex = flex_fwd_bwd_ms(q, k, v, do, scale=D ** -0.5, score_mod=bias_mod(bias))
        except Exception as e:  # noqa: BLE001 -- a compile that fails is logged, not fatal
            log("wide bias", f"flex_attention at D {D} with the bias as score_mod failed: "
                             f"{type(e).__name__}: {str(e)[:200]}")
            flex = (None, None)
        leaf = bias.to(torch.bfloat16).requires_grad_(True) if dbias else None
        sdpa_fwd = _sdpa_backends_ms(q, k, v, attn_mask=bias, call="attn_mask=the f32 bias")
        sdpa_bwd = (_sdpa_backends_ms(q, k, v, do=do, attn_mask=leaf, bias_leaf=leaf,
                                      call="attn_mask=the bias in bf16, which requires grad: "
                                           "dQ, dK, dV and dbias in one call")
                    if dbias else
                    _sdpa_backends_ms(q, k, v, do=do, attn_mask=bias, call="attn_mask=the f32 bias"))
        del leaf
        for key, ms, plain_ms, nbytes, n_flops, sdpa, t_flex, what in (
                (f"k1_{name}", cuda_ms(lambda: flash_fwd.fwd(q, k, v, **kw)),
                 cuda_ms(lambda: flash_fwd.fwd_reference(q, k, v, **kw), reps=3, trials=3),
                 tensor_bytes(q, k, v, q, bias) + stats, 2 * flops, sdpa_fwd, flex[0], ""),
                (f"bwd_{name}", cuda_ms(lambda: flash_bwd.bias_bwd(*args, want_dbias=dbias, **kw)),
                 cuda_ms(lambda: flash_bwd.bias_bwd_reference(*args, want_dbias=dbias, **kw),
                         reps=2, trials=3),
                 tensor_bytes(*args, bias, q, k, v) + (tensor_bytes(out["dbias"]) if dbias else 0),
                 5 * flops, sdpa_bwd, flex[1], "the backward of ")):
            lib = [(sdpa["library_ms"], sdpa["library_call"])]
            if t_flex is not None:
                lib.append((t_flex, f"{what}flex_attention (torch.compile) with the bias as "
                                    "score_mod"))
            best = min(lib)
            res[key] = {"max_abs_err": out["fwd_err" if key.startswith("k1") else "bwd_err"],
                        "ms": ms, "plain_ms": plain_ms, **bound(nbytes, n_flops),
                        "library_ms": best[0], "library_call": best[1],
                        "sdpa_ms": sdpa["library_ms"], "sdpa_call": sdpa["library_call"],
                        "flex_ms": t_flex}
            r = res[key]
            log("wide bias", f"{key} at B{B} H{H} N{N} D{D}: {r['ms']:.4f} ms (plain "
                             f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} {r['bound_by']}; "
                             f"SDPA {r['sdpa_ms']:.4f} ({r['sdpa_call']}), flex "
                             + ("not measured" if t_flex is None else f"{t_flex:.4f}")
                             + f"; library {r['library_ms']:.4f}: {r['library_call']}) "
                             f"({_card_state()})")
        del out, args
        torch.cuda.empty_cache()
    return res


def phase_wide_bias_check() -> dict:
    """The bias routes' D 256 forms (K1: fwd_bias_sm90_kernel<256, SEG, CAP>,
    the bias in one TMA slot; K5 + K6: bwd_bias_wide_kernel<SEG, CAP>, the
    bias from L2, dbias on a runtime pointer) against their plain versions on
    WIDE_BIAS_CASES (_fwd_bwd_check: q and k at GROW; one launch each, of the
    D 256 forms; O, LSE, dQ, dK, dV and dbias within their budgets and
    WINDOW_REL_L2; dead rows' O exactly 0 and LSE exactly ln2 · mask, their
    dQ and dbias exactly 0; dbias exactly 0 on every pair the masks drop,
    read from NaN-filled memory). Then the eight instantiations' SASS
    (HGMMA, UTMALDG, no HMMA) with their registers and spills, and the forms
    timed at path A's D 256 shape (_wide_bias_timing)."""
    from flashattn_tpu_torch.utils.testing import make_qkv

    t0 = time.perf_counter()
    for i, case in enumerate(WIDE_BIAS_CASES):
        tag, d, B, Hq, Hkv, nq, nk, kvl, causal, window, ids, (qo, ko), kind, cap, dbias, dead = case
        q, k, v = _grown(1600 + i, B, Hq, nq, d, nk, Hkv)
        do = _bnhd(make_qkv(1630 + i, B, Hq, nq, d, dtype=torch.bfloat16, device=DEVICE)[0])
        kw = dict(scale=d ** -0.5, causal=causal, bias=_wide_bias(kind, 1660 + i, B, Hq, nq, nk))
        if kvl is not None:
            kw["kv_valid_len"] = kvl
        if window is not None:
            kw["window"] = window
        if ids is not None:
            kw["segment_ids"] = _band_ids(B, nq, nk)
        if (qo, ko) != (0, 0):
            kw.update(q_offset=qo, kv_offset=ko)
        if cap is not None:
            kw["softcap"] = cap
        out = _fwd_bwd_check(f"{tag}: D{d} B{B} Hq{Hq} Hkv{Hkv} Nq{nq} Nk{nk}"
                             f"{'' if kvl is None else f' kv_valid_len {kvl}'}"
                             f"{' causal' if causal else ''}"
                             f"{'' if window is None else f', window {window}'}"
                             f"{'' if ids is None else ', 8 documents'}"
                             f"{'' if (qo, ko) == (0, 0) else f', offsets {(qo, ko)}'}, bias "
                             f"{list(kw['bias'].shape)}{'' if cap is None else f', softcap {cap}'}"
                             f"{', dbias' if dbias else ''}", q, k, v, do, phase="wide bias",
                             want_dbias=dbias, **kw)
        if dead != bool(out["dead"]):
            fail(f"the D 256 bias case {tag} has {out['dead']} dead rows")
        del q, k, v, do, kw, out
        torch.cuda.empty_cache()
    log("wide bias", f"{len(WIDE_BIAS_CASES)} cases checked in {time.perf_counter() - t0:.1f} s")
    _tma_wgmma_sass("wide bias", wide_bias_instantiations())
    t0 = time.perf_counter()
    res = _wide_bias_timing()
    log("wide bias", f"timed in {time.perf_counter() - t0:.1f} s")
    return res


def phase_wide_bias_train() -> dict:
    """Path A with heads of 256: FlashMultiHeadDotProductAttention
    (WIDE_ATTN_WIDTH, bf16, impl "fused") on x [4, 2048, 2048] with the
    key-padding mask of ATTN_LENGTHS (_path_a_inputs), in five arms
    (_path_a): the mask alone; the mask plus a trainable [1, 8, N, N] bias
    (dbias); the module with the window BAND_WINDOW and the mask; packed, 8
    documents a row with the trainable bias through flash_attention(bias=,
    segment_ids=); capped, the mask's bias with logit_softcap 50 through
    flash_attention between the module's projections. Each arm's gates (1.5x
    the bf16 floor against the plain f32 function), LM_STEPS AdamW steps,
    ms/step and peak GB, and exact launches: every K1 call on the bias
    route's D 256 form, every backward on the bias backward's D 256 form."""
    x, target, valid, mask, rel0 = _path_a_inputs(WIDE_ATTN_WIDTH)
    B, N = x.shape[:2]
    kw = dict(width=WIDE_ATTN_WIDTH, phase="wide bias_train")
    return {"mask": _path_a("mask", x, target, valid, mask, None, **kw),
            "learned": _path_a("learned", x, target, valid, mask, rel0, **kw),
            "window": _path_a("windowed mask", x, target, valid, mask, None, window=BAND_WINDOW,
                              **kw),
            "packed": _path_a("packed learned", x, target, torch.ones_like(valid), None, rel0,
                              ids=packed_ids(B, N), **kw),
            "capped": _path_a("capped mask", x, target, valid, mask, None, softcap=SOFTCAP, **kw)}


# K1's quantized route (csrc/flash_fwd_quant_sm90.cu), each case on int8
# and on fp8 K/V quantized by quantize_kv from q, k grown by GROW: (tag, D,
# B, Hq, Hkv, Nq, Nk, kv_valid_len, causal, window, ids kind as
# _seg_case_ids, (q_offset, kv_offset), bias kind -- None, "keys" (key
# padding [B, 1, 1, Nk]) or "full" (key padding plus a normal [B, Hq, Nq,
# Nk]) --, BNHD views (the cache's layout, the scales' strides as
# flash_attention_quantized(layout="BNHD") passes them), has dead rows) --
# D 64 / 96 / 128 / 192 / 256 and 40 / 136 in wider boxes, causal, windows,
# ids, offsets, biases, GQA, ragged tails, kv_valid_len 0, one query row.
QUANT_CASES = [
    ("the LM's prefill, causal GQA 16/8", 128, 1, 16, 8, 1024, 1024, None, True, None, None,
     (0, 0), None, True, False),
    ("window (256, 256), GQA 8/2", 64, 2, 8, 2, 1000, 1000, None, False, (256, 256), None,
     (0, 0), None, False, False),
    ("8 documents a row, causal, D 96", 96, 2, 8, 4, 1024, 1024, None, True, None, "packed",
     (0, 0), None, True, False),
    ("causal, kv_offset 512 (rows before it see no key), D 192", 192, 1, 8, 4, 1024, 1024,
     None, True, None, None, (0, 512), None, False, True),
    ("ragged Nq 1000 / Nk 1100, kv_valid_len 1030, full bias", 256, 2, 8, 4, 1000, 1100, 1030,
     False, None, None, (0, 0), "full", True, False),
    ("ids + window (300, -1) + q_offset 128 + full bias", 128, 2, 8, 4, 1024, 1024, None, True,
     (300, -1), "random", (128, 0), "full", False, None),
    ("D 40, GQA 8/1, Nq 900 / Nk 800, kv_valid_len 700", 40, 1, 8, 1, 900, 800, 700, False,
     None, None, (0, 0), None, True, False),
    ("kv_valid_len 0", 128, 1, 4, 2, 256, 256, 0, False, None, None, (0, 0), None, False, True),
    ("SWA window (511, -1), causal", 128, 1, 16, 8, 2048, 2048, None, True, (511, -1), None,
     (0, 0), None, True, False),
    ("Nq 1, key padding, D 96", 96, 2, 8, 4, 1, 1000, None, False, None, None, (0, 0), "keys",
     False, False),
    ("D 136, key padding, causal", 136, 2, 8, 8, 700, 700, None, True, None, None, (0, 0),
     "keys", True, False),
    ("a segment no key carries, D 64", 64, 1, 8, 8, 1024, 1024, None, False, None, "dead",
     (0, 0), None, False, True),
]
# The quantized prefill: flash_attention_quantized (causal) at the LM's
# attention, B1 Hq16 Hkv8 N2048 D128; and int8 K/V with SWA's window at
# WINDOW_CASES[0]'s shape.
QUANT_PREFILL_SHAPE = (1, 16, 8, LM_SEQ, 128)  # B, Hq, Hkv, N, D


def quant_instantiations() -> set:
    """K1's quantized route's 24 instantiations, as instantiation_name names
    them: fwd_quant_sm90_kernel<D, KV, BIAS, SEG>."""
    return {f"K1 quant sm90 {kv}{' bias' if bi else ''}{' segments' if sg else ''} "
            f"fwd_quant_sm90_kernel<{d}, {code}, {bi}, {sg}>"
            for d in (64, 128, 256) for kv, code in (("int8", 1), ("fp8", 2))
            for bi in (0, 1) for sg in (0, 1)}


def quant_f32_instantiations() -> set:
    """The quantized route's f32-q form's 24 instantiations:
    fwd_quant_f32_kernel<D, KV, BIAS, SEG>."""
    return {n.replace("K1 quant sm90", "K1 quant f32").replace("fwd_quant_sm90_kernel",
                                                                "fwd_quant_f32_kernel")
            for n in quant_instantiations()}


def _quant_case(i: int, dtype, q_dtype=torch.bfloat16):
    """QUANT_CASES[i]'s inputs on ``dtype`` K/V: q (bf16, or with ``q_dtype``
    f32 the same draw before its bf16 rounding, so that its small pieces are
    not 0), the QuantizedKV (its payload and scales BNHD views where the
    case says so) and the keyword arguments of its call; and its tag."""
    from flashattn_tpu_torch.ops import quant
    from flashattn_tpu_torch.utils.testing import make_qkv

    tag, d, B, Hq, Hkv, nq, nk, kvl, causal, window, ids, (qo, ko), bias, bnhd, _ = QUANT_CASES[i]
    q, k, v = _grown(1800 + i, B, Hq, nq, d, nk, Hkv)  # [B, H, N, D] views of [B, N, H, D]
    if q_dtype == torch.float32:
        q = _bnhd(GROW * make_qkv(1800 + i, B, Hq, nq, d, Nk=nk, Hkv=Hkv, device=DEVICE)[0])
    if bnhd:  # quantized in the cache's layout, passed as views
        qkv = quant.quantize_kv(*(x.transpose(1, 2) for x in (k, v)), dtype, allow_slow_fp8=True)
        qkv = quant.QuantizedKV(*(x.transpose(1, 2) for x in qkv))
    else:
        q = q.contiguous()
        qkv = quant.quantize_kv(k.contiguous(), v.contiguous(), dtype, allow_slow_fp8=True)
    kw = dict(scale=d ** -0.5, causal=causal, k_scale=qkv.k_scale, v_scale=qkv.v_scale)
    if kvl is not None:
        kw["kv_valid_len"] = kvl
    if window is not None:
        kw["window"] = window
    if ids is not None:
        kw["segment_ids"] = _seg_case_ids(ids, 1830 + i, B, nq, nk)
    if (qo, ko) != (0, 0):
        kw.update(q_offset=qo, kv_offset=ko)
    if bias is not None:  # batch row b's last 37 (b + 1) keys padded
        from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE

        lengths = torch.tensor([nk - 37 * (r + 1) for r in range(B)], device=DEVICE)
        keys = torch.arange(nk, device=DEVICE)[None] < lengths[:, None]
        kw["bias"] = torch.where(keys, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)[:, None, None]
        if bias == "full":
            gen = torch.Generator(device=DEVICE).manual_seed(1860 + i)
            kw["bias"] = kw["bias"] + torch.randn((B, Hq, nq, nk), generator=gen, device=DEVICE)
    name = ("f32 q, " if q_dtype == torch.float32 else "") + (
        "int8" if dtype == torch.int8 else "fp8")
    return q, qkv, kw, (f"{name} K/V, {tag}: D{d} B{B} Hq{Hq} Hkv{Hkv} Nq{nq} Nk{nk}"
                        f"{'' if kvl is None else f' kv_valid_len {kvl}'}"
                        f"{' BNHD' if bnhd else ''}")


def _quant_timing() -> dict:
    """K1's quantized route timed: flash_attention_quantized(causal=True) at
    QUANT_PREFILL_SHAPE on int8 and fp8 K/V (quantize_kv), one launch of the
    route each (not decode-shaped: Nq is the whole prompt), held against
    fwd_reference on the same quantized K/V and scales (FWD_TOL[bf16]); and
    int8 K/V with SWA's window (WINDOW_CASES[0]: B1 Hq16 Hkv8 N8192 D128,
    (2047, -1) causal) through flash_fwd.fwd. Each row: its time (the call's
    CUDA-event time; "kernel_ms" the kernel alone by torch.profiler,
    "host_ms" the host's time a call: where the host's time nears the
    kernel's, the call's reads the host), the plain version's, its bound (the quantized K/V and scales read once, q read and
    O and the LSE written once; the attended pairs' two products) and SDPA's
    on the dequantized bf16 K/V (each fused backend, _sdpa_backends_ms; with
    the window, its band as a boolean attn_mask) -- the dequantization not
    included."""
    from flashattn_tpu_torch.ops import flash_fwd, quant
    from flashattn_tpu_torch.utils.testing import FWD_TOL, check_close, make_qkv

    res = {}
    B, Hq, Hkv, N, D = QUANT_PREFILL_SHAPE
    q, k, v = make_qkv(1700, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16, device=DEVICE)
    sw = WINDOW_CASES[0]
    qs, ks, vs = make_qkv(1701, sw[1], sw[2], sw[4], sw[6], Hkv=sw[3], dtype=torch.bfloat16,
                          device=DEVICE)
    rows = (("prefill_int8", torch.int8, q, k, v, dict(causal=True)),
            ("prefill_fp8", torch.float8_e4m3fn, q, k, v, dict(causal=True)),
            ("swa_int8", torch.int8, qs, ks, vs, dict(causal=True, window=sw[8])))
    for key, dt, qq, kk, vv, mask in rows:
        b, hq, n, d = qq.shape
        qkv = quant.quantize_kv(kk, vv, dt, allow_slow_fp8=True)
        kw = dict(scale=d ** -0.5, k_scale=qkv.k_scale, v_scale=qkv.v_scale, **mask)
        if "window" in mask:
            call = lambda: flash_fwd.fwd(qq, qkv.k_q, qkv.v_q, **kw)  # noqa: E731
            what = f"flash_fwd.fwd, window {mask['window']} causal"
        else:
            call = lambda: quant.flash_attention_quantized(qq, qkv, causal=True)  # noqa: E731
            what = "flash_attention_quantized(causal=True)"
        before = _launches()
        o = call()
        o = o[0] if isinstance(o, tuple) else o
        torch.cuda.synchronize()
        name = "int8" if dt == torch.int8 else "fp8"
        _routed(f"{what} on {name} K/V", before, K1=1, K1_quant_sm90=1, **{f"K1_{name}": 1},
                K1_window=int("window" in mask))
        plain = lambda: flash_fwd.fwd_reference(qq, qkv.k_q, qkv.v_q, **kw)  # noqa: E731
        o_want = plain()[0]
        ok, msg = check_close(o, o_want, FWD_TOL[torch.bfloat16], "O")
        if not ok:
            fail(f"{what} on {name} K/V at B{b} Hq{hq} N{n} D{d}: {msg}")
        pairs = dict(kv_valid_len=n, segment_ids=None, **mask)
        kd, vd = (x.to(torch.bfloat16) for x in quant.dequantize_kv(qkv))
        if "window" in mask:
            band = flash_fwd.pair_mask(n, n, device=DEVICE, **pairs)[0, 0]
            lib = _sdpa_backends_ms(qq, kd, vd, attn_mask=band,
                                    call="attn_mask=the band, on the dequantized bf16 K/V")
            del band
        else:
            lib = _sdpa_backends_ms(qq, kd, vd, is_causal=True,
                                    call="is_causal=True, on the dequantized bf16 K/V")
        res[key] = {
            "launches": 1, "max_abs_err": (o.float() - o_want.float()).abs().max().item(),
            "ms": cuda_ms(call), "kernel_ms": kernels_ms(call), "host_ms": host_ms(call),
            "plain_ms": cuda_ms(plain, reps=3, trials=3),
            **bound(tensor_bytes(qq, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale, qq)
                    + 4 * b * hq * n, pair_flops(qq, kk, matmuls=2, **pairs)),
            **lib}
        r = res[key]
        log("quant", f"{what}, {name} K/V, B{b} Hq{hq} Hkv{kk.shape[1]} N{n} D{d}: "
                     f"{r['ms']:.4f} ms (kernel alone {r['kernel_ms']:.4f}, host "
                     f"{r['host_ms']:.4f} a call; plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
                     f"{r['bound_by']}, library {r['library_ms']:.4f}: {r['library_call']}); "
                     f"O {msg} ({_card_state()})")
        del qkv, o, o_want, kd, vd
        torch.cuda.empty_cache()
    return res


def _quant_f32_timing() -> dict:
    """The quantized route's f32-q form timed at the f32 LM's prefill:
    flash_attention_quantized(causal=True) with an f32 q at
    QUANT_PREFILL_SHAPE on int8 and fp8 K/V, one launch of the form and one
    split of q each, held against fwd_reference on the same K/V and scales
    (FWD_TOL[f32]); its time (the call's CUDA-event time, the split's
    included; "kernel_ms" the kernels alone), the plain version's, its bound
    (three bf16 products per f32 product at 989 TFLOP/s, 0.052 ms; the bytes
    of q, the 8-bit K/V, the scales, O and the LSE once) and SDPA's faster
    f32 backend on the dequantized f32 K/V, TF32 off, the dequantization not
    included."""
    from flashattn_tpu_torch.ops import quant
    from flashattn_tpu_torch.ops.flash_fwd import fwd_reference
    from flashattn_tpu_torch.utils.testing import FWD_TOL, check_close, make_qkv

    _f32_tf32_off()
    res = {}
    B, Hq, Hkv, N, D = QUANT_PREFILL_SHAPE
    q, k, v = make_qkv(1702, B, Hq, N, D, Hkv=Hkv, device=DEVICE)  # f32
    for name, dt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        qkv = quant.quantize_kv(k, v, dt, allow_slow_fp8=True)
        call = lambda: quant.flash_attention_quantized(q, qkv, causal=True)  # noqa: E731
        before = _launches()
        o = call()
        torch.cuda.synchronize()
        _routed(f"flash_attention_quantized(causal=True) on {name} K/V, f32 q", before, K1=1,
                K1_quant_f32=1, split_bf16x3=1, **{f"K1_{name}": 1})
        kw = dict(scale=D ** -0.5, causal=True, k_scale=qkv.k_scale, v_scale=qkv.v_scale)
        plain = lambda: fwd_reference(q, qkv.k_q, qkv.v_q, **kw)  # noqa: E731
        o_want = plain()[0]
        ok, msg = check_close(o, o_want, FWD_TOL[torch.float32], "O")
        if not ok or o.dtype != torch.float32:
            fail(f"the quantized route's f32-q form at the f32 LM's prefill on {name} K/V: "
                 f"{msg} (O {o.dtype})")
        pairs = dict(kv_valid_len=N, causal=True, segment_ids=None)
        kd, vd = quant.dequantize_kv(qkv, torch.float32)
        res[f"prefill_f32_{name}"] = {
            "launches": 1, "max_abs_err": (o - o_want).abs().max().item(),
            "ms": cuda_ms(call), "kernel_ms": kernels_ms(call),
            "plain_ms": cuda_ms(plain, reps=3, trials=3),
            **bound(tensor_bytes(q, qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale, q) + 4 * B * Hq * N,
                    3 * pair_flops(q, k, matmuls=2, **pairs)),
            **_f32_library_ms(q, kd, vd, None, dict(is_causal=True))}
        r = res[f"prefill_f32_{name}"]
        r["library_call"] = f"{r['library']} on the dequantized f32 K/V, is_causal=True"
        log("quant", f"f32 q, {name} K/V, the f32 LM's prefill B{B} Hq{Hq} Hkv{Hkv} N{N} D{D} "
                     f"causal: {r['ms']:.4f} ms (kernels alone {r['kernel_ms']:.4f}; plain "
                     f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} {r['bound_by']}, library "
                     f"{r['library_ms']:.4f}: {r['library_call']}); O {msg} ({_card_state()})")
        del qkv, o, o_want, kd, vd
        torch.cuda.empty_cache()
    return res


def phase_quant_check() -> dict:
    """K1's quantized route (fwd_quant_sm90_kernel<D, KV, BIAS, SEG>: int8 /
    e4m3 K/V widened in shared memory) against fwd_reference on the same
    8-bit K/V and scales: QUANT_CASES on int8 and on fp8 (_fwd_bwd_check
    without dO: one launch each of the route, counted with the dtype and the
    window; O within FWD_TOL[bf16] and WINDOW_REL_L2, LSE within LSE_ATOL on
    live rows, dead rows' O exactly 0 and LSE exactly ln2 · mask); then every
    case again with an f32 q, on the route's f32-q form
    (fwd_quant_f32_kernel<D, KV, BIAS, SEG>: one launch and one split of q
    each; O within FWD_TOL[f32], LSE within F32_LSE_ATOL, dead rows the
    same). Then the 48 instantiations' SASS (HGMMA, UTMALDG, no HMMA) with
    their registers and spills, and both forms timed (_quant_timing,
    _quant_f32_timing)."""
    _f32_tf32_off()
    t0 = time.perf_counter()
    for q_dtype in (torch.bfloat16, torch.float32):
        for i, case in enumerate(QUANT_CASES):
            for dt in (torch.int8, torch.float8_e4m3fn):
                q, qkv, kw, tag = _quant_case(i, dt, q_dtype)
                out = _fwd_bwd_check(tag, q, qkv.k_q, qkv.v_q, None, phase="quant", **kw)
                if case[-1] is not None and case[-1] != bool(out["dead"]):
                    fail(f"the quantized case {tag} has {out['dead']} dead rows")
                del q, qkv, kw, out
            torch.cuda.empty_cache()
    log("quant", f"{4 * len(QUANT_CASES)} cases checked in {time.perf_counter() - t0:.1f} s")
    _tma_wgmma_sass("quant", quant_instantiations() | quant_f32_instantiations())
    t0 = time.perf_counter()
    res = {**_quant_timing(), **_quant_f32_timing()}
    log("quant", f"timed in {time.perf_counter() - t0:.1f} s")
    return res


def phase_entry() -> dict:
    """The port's entry points on the card: ``entry()``'s denoise step (its
    output's shape, dtype and finiteness; the launches it made -- none: every
    attention there takes the exact path) and ``dryrun_multichip(8)`` (three
    finite losses, launches only on the f32 kernels)."""
    from flashattn_tpu_torch import entry as E

    _reset_launches()
    fn, args = E.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    launched = {n: c for n, c in _launches().items() if c}
    log("entry", f"entry(): {tuple(out.shape)} {out.dtype}, finite "
                 f"{bool(torch.isfinite(out).all())}, max|out| {out.abs().max().item():.3e}; "
                 f"launches {launched} (the exact path everywhere at this size)")
    if tuple(out.shape) != (1, 32, 32, 4) or out.dtype != torch.float32 or not bool(
            torch.isfinite(out).all()):
        fail(f"entry(): output {tuple(out.shape)} {out.dtype} not [1, 32, 32, 4] f32 finite")
    del fn, args, out
    _reset_launches()
    losses = E.dryrun_multichip(8)
    counts = _launches()
    other = {n: c for n, c in counts.items()
             if c and n not in ("K1", "K1 f32", "K3", "split bwd", "bwd f32", "split bf16x3")}
    log("entry", f"dryrun_multichip(8): losses {losses}, launches "
                 f"{ {n: c for n, c in counts.items() if c} }")
    if (len(losses) != 3 or not all(math.isfinite(x) for x in losses) or other
            or counts["K1 f32"] == 0 or counts["K1"] != counts["K1 f32"]
            or counts["bwd f32"] != counts["K3"] + counts["split bwd"] or counts["bwd f32"] == 0
            or counts["split bf16x3"] != counts["K1 f32"] + counts["bwd f32"]):
        fail(f"dryrun_multichip(8): losses {losses}, launches {counts}: expected three finite "
             "losses on the f32 kernels only")
    return {"dryrun": counts, "losses": losses}


# phase_utilities: the LM whose training it checkpoints (LM_WIDTH at this
# depth: the 8-layer model's weights and AdamW moments are 4.4 GB on disk)
# and the steps before the checkpoint.
CKPT_LAYERS = 2
CKPT_STEPS = 2


def phase_utilities() -> dict:
    """The utilities on the card. utils/checkpoint.py: the LM (LM_WIDTH at
    CKPT_LAYERS layers, bf16, [1, LM_SEQ + 1] tokens) takes CKPT_STEPS AdamW
    steps, is checkpointed (weights, AdamW state, step) under
    latest_step_dir's layout in the build directory, and takes one more step
    (the uninterrupted run); a fresh model and a fresh AdamW state restored
    from the checkpoint (``like=`` them) take that step again: its loss must
    equal the uninterrupted step's bit for bit (the forward has no
    atomics), and the restored state its saved dtypes. utils/profiling.py:
    capture_attention_trace at its defaults (B1 H24 N4096 D128) writes a
    Chrome trace that must name K1's dense route (fwd_dense_sm90_kernel) and
    K3 (bwd_sm90_kernel); dump_kernel_ir writes flash_fwd_sm90.cu's PTX
    (naming the kernel, with wgmma) and the library's SASS (with HGMMA)."""
    import dataclasses
    import shutil

    from flashattn_tpu_torch.models.transformer import (
        TransformerConfig, adamw_init, adamw_update, init_transformer, lm_loss)
    from flashattn_tpu_torch.utils import checkpoint, native, profiling

    cfg = dataclasses.replace(TransformerConfig(**LM_WIDTH), n_layers=CKPT_LAYERS)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_SEQ + 1),
                           generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE)

    def fresh():
        model = init_transformer(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                                 device=DEVICE)
        params = dict(model.named_parameters())
        return model, params, adamw_init(params)

    def step(model, params, opt):
        model.zero_grad(set_to_none=True)
        loss = lm_loss(model, tokens, cfg)
        loss.backward()
        opt = adamw_update({n: p.grad for n, p in params.items()}, opt, params)[1]
        return loss.item(), opt

    root = native.BUILD_DIR / "checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    model, params, opt = fresh()
    losses = []
    for _ in range(CKPT_STEPS):
        loss, opt = step(model, params, opt)
        losses.append(loss)
    t0 = time.perf_counter()
    path = checkpoint.save(str(root / str(CKPT_STEPS) / "state.pt"),
                           {"params": params, "opt": opt, "step": CKPT_STEPS})
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path) / 1e9
    uninterrupted, _ = step(model, params, opt)
    del model, params, opt
    torch.cuda.empty_cache()
    model, params, opt = fresh()
    t0 = time.perf_counter()
    state = checkpoint.restore(os.path.join(checkpoint.latest_step_dir(str(root)), "state.pt"),
                               like={"params": params, "opt": opt, "step": 0})
    restore_s = time.perf_counter() - t0
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(state["params"][n])
    opt = state["opt"]
    counts = (state["step"], opt["count"])
    resumed, _ = step(model, params, opt)
    dtypes = ({p.dtype for p in state["params"].values()}, {m.dtype for m in opt["mu"].values()})
    log("utilities", f"checkpoint of the LM ({sum(p.numel() for p in params.values()) / 1e6:.0f} "
                     f"M params, {cfg.n_layers} layers, bf16) after step {CKPT_STEPS}: "
                     f"{size:.2f} GB written in {save_s:.2f} s, restored in {restore_s:.2f} s; "
                     f"losses {losses}, step {CKPT_STEPS + 1} uninterrupted {uninterrupted!r}, "
                     f"resumed {resumed!r}; restored dtypes {dtypes}, step and AdamW count "
                     f"{counts}")
    del model, params, opt, state
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    if (resumed != uninterrupted or dtypes != ({torch.bfloat16}, {torch.float32})
            or counts != (CKPT_STEPS, CKPT_STEPS)):
        fail(f"the resumed step's loss {resumed!r} is not the uninterrupted one's "
             f"{uninterrupted!r}, or the restored dtypes {dtypes} are not bf16 / f32, or the "
             f"step and AdamW count {counts} are not {CKPT_STEPS}")

    trace_dir = native.BUILD_DIR / "trace"
    # CUPTI can drop a capture's kernels in a process that profiled before
    # (_profiled): up to three captures.
    for attempt in range(3):
        shutil.rmtree(trace_dir, ignore_errors=True)
        t0 = time.perf_counter()
        out = profiling.capture_attention_trace(str(trace_dir))
        with open(os.path.join(out, profiling.TRACE_FILE)) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        kernels = {k: sorted(n for n in names if k in n)
                   for k in ("fwd_dense_sm90_kernel", "bwd_sm90_kernel")}
        log("utilities", f"capture_attention_trace (B1 H24 N4096 D128, fwd + bwd), capture "
                         f"{attempt + 1}, in {time.perf_counter() - t0:.1f} s: {len(names)} event "
                         f"names; K1 / K3 kernels named: {kernels}; regions flash_fwd "
                         f"{'flash_fwd' in names}, flash_bwd {'flash_bwd' in names}")
        if all(kernels.values()):
            break
    if not all(kernels.values()) or not {"flash_fwd", "flash_bwd"} <= names:
        fail(f"the attention trace names no K1 or K3 kernel, or misses a region: {kernels}")
    t0 = time.perf_counter()
    ir = profiling.dump_kernel_ir(str(native.BUILD_DIR / "ir"), sources=("flash_fwd_sm90.cu",))
    ptx = open(ir["ptx"][0]).read()
    sass = open(ir["sass"]).read()
    log("utilities", f"dump_kernel_ir in {time.perf_counter() - t0:.1f} s: PTX {len(ptx)} bytes "
                     f"({ptx.count('wgmma.mma_async')} wgmma.mma_async), SASS {len(sass)} bytes "
                     f"({sass.count('HGMMA')} HGMMA)")
    if "fwd_dense_sm90_kernel" not in ptx or "wgmma.mma_async" not in ptx or "HGMMA" not in sass:
        fail("dump_kernel_ir: the PTX or the SASS lacks K1's dense route or its wgmma")
    shutil.rmtree(trace_dir, ignore_errors=True)
    shutil.rmtree(native.BUILD_DIR / "ir", ignore_errors=True)
    return {"resumed_loss": resumed, "checkpoint_gb": size}


def main() -> None:
    global YARDSTICKS
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import flashattn_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    YARDSTICKS = "--yardsticks" in sys.argv[1:]
    t_start = time.perf_counter()

    def timed(phase):
        t0 = time.perf_counter()
        out = phase()
        log("time", f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    timed(phase_env)
    timed(phase_build)
    timed(phase_utilities)
    k1 = timed(phase_kernel_check)
    k1c = timed(phase_causal_check)
    k3 = timed(phase_bwd_check)
    seg = timed(phase_seg_check)
    launches = timed(phase_slice)
    k1c_launches, k3_launches = timed(phase_train)
    packed = timed(phase_packed_train)
    dec_k = timed(phase_decode_check)
    dec = timed(phase_decode)
    dec_f32 = timed(phase_decode_f32)
    win = timed(phase_window_check)
    swa = timed(phase_swa_train)
    cap = timed(phase_softcap)
    bias = timed(phase_bias_check)
    band = timed(phase_bias_band_check)
    bias_train = timed(phase_bias_train)
    roof = timed(phase_roofline)
    roof_f32 = timed(phase_roofline_f32)
    ring = timed(phase_ring)
    ring_wide = timed(phase_ring_wide)
    sharded = timed(phase_sharded_train)
    f32 = timed(phase_f32_check)
    f32_train = timed(phase_f32_train)
    f32_bias = timed(phase_f32_bias_check)
    f32_path_a = timed(phase_f32_bias_train)
    f32_wide = timed(phase_f32_wide_check)
    f32_wide_train = timed(phase_f32_wide_train)
    wide = timed(phase_wide_bwd_check)
    wide_train = timed(phase_wide_train)
    wide_bias = timed(phase_wide_bias_check)
    wide_bias_train = timed(phase_wide_bias_train)
    quant = timed(phase_quant_check)
    timed(phase_entry)
    timed(phase_fuzz)
    log("time", f"total: {time.perf_counter() - t_start:.1f} s (yardsticks "
                f"{'on' if YARDSTICKS else 'off: python3 chip_smoke.py --yardsticks times them'}; "
                + ", ".join(f"{k} {v:.1f} s" for k, v in YARDSTICK_SECONDS.items()) + ")")
    fwd_src, bwd_src, split_src, bias_sm90_src = (
        f"flashattn_tpu_torch/csrc/flash_{d}.cu"
        for d in ("fwd_sm90", "bwd_sm90", "bwd_split_sm90", "fwd_bias_sm90"))
    bias_bwd_src = "flashattn_tpu_torch/csrc/bwd_bias_sm90.cu"
    split_replaces = "flashattn_tpu/ops/flash_bwd.py:139, flashattn_tpu/ops/flash_bwd.py:234"
    # K1's decode route: the decode kernel and, where a call has more than one
    # split, its merge kernel, both launched by flash_fwd.fwd's one C call
    # (their times are the call's); launches are the decode kernel's.
    decode_kernels = [
        {"name": f"flash_decode {label} (K1 decode route, {name} cache)", "route": "cuda",
         "source": f"flashattn_tpu_torch/csrc/{src}.cu",
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115", "launches": counts["K1 decode"],
         "merge_launches": counts["K1 merge"], **dec_k[key]}
        for name, label, src, key, counts in (
            ("bf16", "bf16 K/V", "flash_decode", "bf16", dec["bf16"]),
            ("int8", "int8 K/V", "flash_decode_quant", "int8", dec["int8"]),
            ("fp8", "fp8 K/V", "flash_decode_quant", "fp8", dec["fp8"]),
            ("bf16 soft-capped", "softcap", "flash_decode", "softcap", cap["decode"]))]
    print(json.dumps({"kernels": [
        {"name": "flash_fwd_sm90 (K1's dense route, wgmma: SD1.5 U-Net self-attention, D 40)",
         "route": "cuda", "source": fwd_src, "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": launches, **k1},
        {"name": "flash_fwd_sm90 causal (K1's dense route, wgmma: LM causal, K2)",
         "route": "cuda", "source": fwd_src,
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:516",
         "launches": k1c_launches, **k1c},
        {"name": "flash_fwd_sm90 segments (K1's dense route, wgmma: packed LM, causal + "
                 "segment ids)", "route": "cuda", "source": fwd_src,
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": packed["K1 dense sm90"], **seg["k1"]},
        {"name": "flash_bwd_sm90 (K3, wgmma: LM causal, K4)", "route": "cuda", "source": bwd_src,
         "replaces": "flashattn_tpu/ops/flash_bwd_fused.py:110, "
                     "flashattn_tpu/ops/flash_bwd_fused.py:336",
         "launches": k3_launches, **k3},
        {"name": "flash_bwd_split_sm90 segments (K5 + K6 in one launch, wgmma: packed LM, "
                 "causal + segment ids)", "route": "cuda", "source": split_src,
         "replaces": split_replaces, "launches": packed["split bwd"], **seg["split"]},
        *decode_kernels,
        {"name": "flash_fwd_sm90 window (K1's dense route, wgmma: SWA, causal + sliding "
                 "window, K2 windowed)", "route": "cuda", "source": fwd_src,
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:852",
         "launches": swa["K1 dense sm90"], **win["k1_window"]},
        {"name": "flash_bwd_sm90 window (K3, wgmma: SWA, K4 windowed)", "route": "cuda",
         "source": bwd_src,
         "replaces": "flashattn_tpu/ops/flash_bwd_fused.py:110, "
                     "flashattn_tpu/ops/flash_bwd_fused.py:651",
         "launches": swa["K3 sm90"], **win["k3_window"]},
        {"name": "flash_fwd_sm90 softcap (K1's dense route, wgmma: soft-capped SWA, logit "
                 "softcap + sliding window)", "route": "cuda", "source": fwd_src,
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:852",
         "launches": cap["train"]["K1 dense sm90"], **win["k1_softcap"]},
        {"name": "flash_bwd_split_sm90 softcap (K5 + K6 in one launch, wgmma: soft-capped SWA, "
                 "logit softcap + sliding window)", "route": "cuda", "source": split_src,
         "replaces": split_replaces, "launches": cap["train"]["split bwd"],
         **win["split_softcap"]},
        {"name": "flash_fwd_bias_sm90 (K1's bias route, wgmma: key-padding bias, path A's mask "
                 "arm)", "route": "cuda", "source": bias_sm90_src,
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": bias_train["mask"]["launches"]["K1 bias sm90"], **bias["k1_bias"]},
        {"name": "flash_fwd_bias_sm90 (K1's bias route, wgmma: [4, 16, N, N] bias, path A's "
                 "learned arm)", "route": "cuda", "source": bias_sm90_src,
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": bias_train["learned"]["launches"]["K1 bias sm90"],
         **bias["k1_bias_learned"]},
        {"name": "bwd_bias_sm90 (K5 + K6's bias route, wgmma: key-padding bias, path A's mask "
                 "arm)", "route": "cuda", "source": bias_bwd_src, "replaces": split_replaces,
         "launches": bias_train["mask"]["launches"]["bias bwd"], **bias["bias_bwd"]},
        {"name": "bwd_bias_sm90 dbias (K5 + K6's bias route, wgmma: [4, 16, N, N] bias and "
                 "dbias, path A's learned arm)", "route": "cuda", "source": bias_bwd_src,
         "replaces": split_replaces,
         "launches": bias_train["learned"]["launches"]["bias bwd dbias"],
         **bias["bias_bwd_dbias"]},
        # The bias route's backward with the softcap and at D 96, the calls
        # that K5 + K6 on mma.sync took before it: no path of the port makes
        # them, so "path" is null and the launches are a check's, each
        # counted from 0 (phase_bias_check: the soft-capped end-to-end call,
        # the D 96 check at path A's shape); times at path A's shape.
        {"name": "bwd_bias_sm90 softcap (K5 + K6's bias route, wgmma: [4, 16, N, N] bias, "
                 "softcap 50 and dbias, path A's learned arm)", "route": "cuda",
         "source": bias_bwd_src, "replaces": split_replaces, "path": None,
         "launches": bias["e2e_softcap"]["bias bwd dbias"], **bias["bias_bwd_softcap"]},
        {"name": "bwd_bias_sm90 D 96 (K5 + K6's bias route, wgmma: key-padding bias at D 96, "
                 "run in the D 128 instantiation)", "route": "cuda", "source": bias_bwd_src,
         "replaces": split_replaces, "path": None, "launches": bias["launches_d96"],
         **bias["bias_bwd_d96"]},
        # The bias routes with a band or segment ids (phase_bias_band_check's
        # rows at path A's shape, B4 H16 N2048 D128); launches from windowed
        # and packed path A's fused steps (phase_bias_train).
        {"name": "flash_fwd_bias_sm90 window (K1's bias route, wgmma: key-padding bias, window "
                 "(256, 256), windowed path A's mask arm)", "route": "cuda",
         "source": bias_sm90_src, "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": bias_train["window_mask"]["launches"]["K1 bias sm90"],
         **band["k1_window_mask"]},
        {"name": "flash_fwd_bias_sm90 window (K1's bias route, wgmma: [4, 16, N, N] bias, window "
                 "(256, 256), windowed path A's learned arm)", "route": "cuda",
         "source": bias_sm90_src, "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": bias_train["window_learned"]["launches"]["K1 bias sm90"],
         **band["k1_window_learned"]},
        {"name": "flash_fwd_bias_sm90 segments (K1's bias route, wgmma: [1, 16, N, N] bias, 8 "
                 "documents a row, packed path A)", "route": "cuda", "source": bias_sm90_src,
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": bias_train["packed"]["launches"]["K1 bias sm90"],
         **band["k1_docs_learned"]},
        {"name": "bwd_bias_sm90 window (K5 + K6's bias route, wgmma: key-padding bias, window "
                 "(256, 256), windowed path A's mask arm)", "route": "cuda",
         "source": bias_bwd_src, "replaces": split_replaces,
         "launches": bias_train["window_mask"]["launches"]["bias bwd"],
         **band["bwd_window_mask"]},
        {"name": "bwd_bias_sm90 window dbias (K5 + K6's bias route, wgmma: [4, 16, N, N] bias and "
                 "dbias, window (256, 256), windowed path A's learned arm)", "route": "cuda",
         "source": bias_bwd_src, "replaces": split_replaces,
         "launches": bias_train["window_learned"]["launches"]["bias bwd dbias"],
         **band["bwd_window_learned"]},
        {"name": "bwd_bias_sm90 segments dbias (K5 + K6's bias route, wgmma: [1, 16, N, N] bias "
                 "and dbias, 8 documents a row, packed path A)", "route": "cuda",
         "source": bias_bwd_src, "replaces": split_replaces,
         "launches": bias_train["packed"]["launches"]["bias bwd dbias"],
         **band["bwd_docs_learned"]},
        {"name": "gemm (K9, TMA + wgmma)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/gemm.cu",
         "replaces": "flashattn_tpu/ops/gemm.py:22", "launches": roof["launches"]["K9"],
         **roof["k9"]},
        {"name": "roofline (K10)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/roofline.cu",
         "replaces": "flashattn_tpu/ops/roofline.py:28", "launches": roof["launches"]["K10"],
         **roof["k10"]},
        # The probes' f32 forms (phase_roofline_f32): K9 at 4096^3 (its time
        # includes the split of a and b), K10 at size 512, 1024 iterations;
        # bounds at PEAK_F32_ACCURATE_FLOPS; launches from the driving run.
        {"name": "gemm f32 (K9's f32 form, TMA + wgmma on bf16 pieces: six products per f32 "
                 "product)", "route": "cuda", "source": "flashattn_tpu_torch/csrc/gemm.cu",
         "replaces": "flashattn_tpu/ops/gemm.py:22", "launches": roof_f32["launches"]["K9 f32"],
         **roof_f32["k9"]},
        {"name": "roofline f32 (K10's f32 form, mma.sync on bf16 pieces)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/roofline.cu",
         "replaces": "flashattn_tpu/ops/roofline.py:28",
         "launches": roof_f32["launches"]["K10 f32"], **roof_f32["k10"]},
        {"name": "ring fwd step (K7, TMA + wgmma)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/ring_fwd.cu",
         "replaces": "flashattn_tpu/parallel/ring_kernel.py:74, "
                     "flashattn_tpu/parallel/ring_kernel.py:257, "
                     "flashattn_tpu/parallel/ring_kernel.py:357",
         "launches": ring["launches"]["K7"], **ring["k7"]},
        {"name": "ring bwd step (K8, TMA + wgmma)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/ring_bwd.cu",
         "replaces": "flashattn_tpu/parallel/ring_kernel.py:389",
         "launches": ring["launches"]["K8"], **ring["k8"]},
        # The ring kernels' f32 and D 256 forms (phase_ring_wide) at 4 ranks x
        # 4096 causal: the f32 LM's attention (Hq16 Hkv8 D128) and Gemma 2's
        # heads of 256 (Hq8 Hkv4 D256); launches from the form's main-shape
        # runs (causal and, where it has one, windowed); ms the whole ring,
        # an f32 ring's with its splits.
        *({"name": f"ring {step} step {form} (K{7 if step == 'fwd' else 8}'s {form} form, TMA + "
                   f"wgmma{' on bf16 pieces' if 'f32' in form else ''})", "route": "cuda",
           "source": src[step], "replaces": ("flashattn_tpu/parallel/ring_kernel.py:74"
                                             if step == "fwd" else
                                             "flashattn_tpu/parallel/ring_kernel.py:389"),
           "launches": ring_wide[form]["launches"][f"K{7 if step == 'fwd' else 8}"],
           **{k: v for k, v in ring_wide[form][f"k{7 if step == 'fwd' else 8}"].items()
              if k != "step_ms"}}
          for form, src in (
              ("f32", {"fwd": "flashattn_tpu_torch/csrc/flash_fwd_f32.cu",
                       "bwd": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu"}),
              ("bf16 D 256", {"fwd": "flashattn_tpu_torch/csrc/fwd_sm90_tile.cuh",
                              "bwd": "flashattn_tpu_torch/csrc/bwd_sm90_wide.cuh"}),
              ("f32 D 256", {"fwd": "flashattn_tpu_torch/csrc/flash_fwd_f32.cu",
                             "bwd": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu"}))
          for step in ("fwd", "bwd")),
        # The chunk pairs of the sharded LM step (phase_sharded_train): its
        # contiguous step's launches and its packed step's.
        {"name": "K1 dense sm90 offsets (flash_fwd_sm90, wgmma: the contiguous ring's "
                 "neighbour chunk pair, B1 Hq8 Hkv4 2048 x 2048 D128)", "route": "cuda",
         "source": fwd_src, "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": sharded["lm"]["contiguous"]["counts"]["K1 dense sm90"],
         **sharded["rows"]["ring neighbour"][0]},
        {"name": "K3 sm90 offsets (flash_bwd_sm90, wgmma: the contiguous ring's neighbour "
                 "chunk pair)", "route": "cuda", "source": bwd_src,
         "replaces": "flashattn_tpu/ops/flash_bwd_fused.py:110",
         "launches": sharded["lm"]["contiguous"]["counts"]["K3 sm90"],
         **sharded["rows"]["ring neighbour"][1]},
        {"name": "split sm90 offsets (flash_bwd_split_sm90, wgmma: the packed ring's "
                 "neighbour chunk pair, one document across the edge)", "route": "cuda",
         "source": split_src, "replaces": split_replaces,
         "launches": sharded["lm"]["packed"]["counts"]["split bwd"],
         **sharded["rows"]["packed neighbour"][1]},
        # The f32 routes at the f32 LM's attention (B1 Hq16 Hkv8 N2048 D128
        # causal), launches from phase_f32_train's steps, errors against the
        # plain versions on the timed inputs; each time includes the split of
        # its operands; bound at six bf16 products per f32 product
        # (PEAK_F32_ACCURATE_FLOPS); library: the faster of SDPA's math and
        # memory-efficient backends on the f32 inputs, TF32 off, with the
        # documents as a boolean mask ("library" names it).
        {"name": "flash_fwd_f32 causal (K1's f32 route, TMA + wgmma on bf16 pieces: f32 LM "
                 "causal, K2)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/flash_fwd_f32.cu",
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:516",
         "launches": f32_train["unpacked"]["K1 f32"], **f32["fwd"]},
        {"name": "flash_bwd_f32 (K3 on f32, TMA + wgmma on bf16 pieces: f32 LM causal, K4)",
         "route": "cuda", "source": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu",
         "replaces": "flashattn_tpu/ops/flash_bwd_fused.py:110, "
                     "flashattn_tpu/ops/flash_bwd_fused.py:336",
         "launches": f32_train["unpacked"]["bwd f32"], **f32["bwd"]},
        {"name": "flash_fwd_f32 segments (K1's f32 route, TMA + wgmma on bf16 pieces: packed f32 "
                 "LM, causal + segment ids)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/flash_fwd_f32.cu",
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
         "launches": f32_train["packed"]["K1 f32"], **f32["fwd_packed"]},
        {"name": "flash_bwd_f32 segments (K5 + K6 on f32 in one launch, TMA + wgmma on bf16 "
                 "pieces: packed f32 LM, causal + segment ids)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu", "replaces": split_replaces,
         "launches": f32_train["packed"]["bwd f32"], **f32["bwd_packed"]},
        # The f32 routes' operand split: no TPU kernel of its own (the MXU
        # splits its f32 operands under Precision.HIGHEST); launches from the
        # unpacked f32 steps (one in each f32 C entry: q, k, v before K1 f32,
        # q, k, v, dO before the backward); error and device time of the
        # launches that K1 f32's and the backward's C entries made on the
        # f32 LM's timed inputs ("ms": K1 f32's, "bwd_launch_ms" the
        # backward's), read from the scratch the wrappers allocated.
        {"name": "split_bf16x3 (the f32 routes' operand split: q, k, v of the f32 LM's "
                 "attention in one launch, as K1's f32 C entry makes it)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/split_bf16x3.cu",
         "replaces": "none (Precision.HIGHEST's bf16 split inside the MXU: "
                     "flashattn_tpu/ops/flash_fwd.py:232)",
         "launches": f32_train["unpacked"]["split bf16x3"], **f32["split"]},
        # The LM with heads of 256 (phase_wide_train), at its attention (B1
        # Hq8 Hkv4 N2048 D256 causal, phase_wide_bwd_check's _wide_timing):
        # K1's dense route's, K3's and the split route's D 256 forms;
        # launches from the variants' steps.
        {"name": "flash_fwd_sm90 D 256 causal (K1's dense route's D 256 form, wgmma: the LM "
                 "with heads of 256, K2)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/fwd_sm90_tile.cuh",
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:516",
         "launches": wide_train["unpacked"]["launches"]["K1 dense d256"], **wide["k1"]},
        {"name": "flash_bwd_sm90 D 256 (K3's D 256 form, wgmma: the LM with heads of 256, "
                 "causal, K4)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/bwd_sm90_wide.cuh",
         "replaces": "flashattn_tpu/ops/flash_bwd_fused.py:110, "
                     "flashattn_tpu/ops/flash_bwd_fused.py:336",
         "launches": wide_train["unpacked"]["launches"]["K3 d256"], **wide["k3"]},
        {"name": "flash_bwd_split_sm90 D 256 softcap (K5 + K6's D 256 form in one launch, wgmma: "
                 "the LM with heads of 256, logit softcap 50)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/bwd_sm90_wide.cuh", "replaces": split_replaces,
         "launches": wide_train["softcap"]["launches"]["split bwd d256"], **wide["split_cap"]},
        {"name": "flash_bwd_split_sm90 D 256 segments (K5 + K6's D 256 form in one launch, "
                 "wgmma: the packed LM with heads of 256)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/bwd_sm90_wide.cuh", "replaces": split_replaces,
         "launches": wide_train["packed"]["launches"]["split bwd d256"], **wide["split_seg"]},
        # f32 with a bias at f32 path A's attention (B4 H16 N2048 D128, f32;
        # phase_f32_bias_check's timing), launches from f32 path A's steps
        # (phase_f32_bias_train); each time includes the split of its operands.
        *({"name": f"flash_fwd_f32 bias (K1's f32 route with a bias, TMA + wgmma on bf16 "
                   f"pieces: f32 path A's {arm} arm, bias {shape})", "route": "cuda",
           "source": "flashattn_tpu_torch/csrc/flash_fwd_f32.cu",
           "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
           "launches": f32_path_a[arm]["launches"]["K1 f32 bias"], **f32_bias[f"fwd_{arm}"]}
          for arm, shape in (("mask", "[4, 1, N, N]"), ("learned", "[4, 16, N, N]"))),
        {"name": "flash_bwd_f32 bias (K5 + K6 on f32 with a bias in one launch, TMA + wgmma on "
                 "bf16 pieces: f32 path A's mask arm, bias [4, 1, N, N], no dbias)",
         "route": "cuda", "source": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu",
         "replaces": split_replaces,
         "launches": f32_path_a["mask"]["launches"]["bias bwd f32"], **f32_bias["bwd_mask"]},
        {"name": "flash_bwd_f32 bias dbias (K5 + K6 on f32 with a bias and dbias in one launch, "
                 "TMA + wgmma on bf16 pieces: f32 path A's learned arm, bias [4, 16, N, N])",
         "route": "cuda", "source": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu",
         "replaces": split_replaces,
         "launches": f32_path_a["learned"]["launches"]["bias bwd dbias"],
         **f32_bias["bwd_learned"]},
        # f32 with heads of 256: the D 256 forms at the attention of the f32 LM
        # with heads of 256 (B1 Hq8 Hkv4 N2048 D256 causal) and of f32 path A
        # with heads of 256 (B4 H8 N2048 D256; phase_f32_wide_check's timing),
        # launches from phase_f32_wide_train's steps; each time includes the
        # split of its operands ("kernel_ms": the kernels' device time alone).
        {"name": "flash_fwd_f32 D 256 causal (K1's f32 route's D 256 form, TMA + wgmma on bf16 "
                 "pieces, 64 Q rows a CTA: the f32 LM with heads of 256, K2)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/flash_fwd_f32.cu",
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:516",
         "launches": f32_wide_train["unpacked"]["launches"]["K1 f32 d256"], **f32_wide["fwd"]},
        {"name": "flash_bwd_f32 D 256 (K3 on f32, the D 256 form: a cluster of two CTAs that "
                 "split D, TMA + wgmma on bf16 pieces: the f32 LM with heads of 256, causal, "
                 "K4)", "route": "cuda", "source": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu",
         "replaces": "flashattn_tpu/ops/flash_bwd_fused.py:110, "
                     "flashattn_tpu/ops/flash_bwd_fused.py:336",
         "launches": f32_wide_train["unpacked"]["launches"]["bwd f32 d256"], **f32_wide["bwd"]},
        {"name": "flash_bwd_f32 D 256 softcap (K5 + K6 on f32 in one launch, the D 256 form: "
                 "the f32 LM with heads of 256, logit softcap 50)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu", "replaces": split_replaces,
         "launches": f32_wide_train["softcap"]["launches"]["bwd f32 d256"],
         **f32_wide["bwd_cap"]},
        {"name": "flash_bwd_f32 D 256 segments (K5 + K6 on f32 in one launch, the D 256 form: "
                 "the packed f32 LM with heads of 256)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu", "replaces": split_replaces,
         "launches": f32_wide_train["packed"]["launches"]["bwd f32 d256"],
         **f32_wide["bwd_ids"]},
        *({"name": f"flash_fwd_f32 D 256 bias (K1's f32 route's D 256 form with a bias: f32 "
                   f"path A with heads of 256, {arm} arm, bias {shape})", "route": "cuda",
           "source": "flashattn_tpu_torch/csrc/flash_fwd_f32.cu",
           "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
           "launches": f32_wide_train["path_a"][arm]["launches"]["K1 f32 d256"],
           **f32_wide[f"fwd_{arm}"]}
          for arm, shape in (("mask", "[4, 1, N, N]"), ("learned", "[4, 8, N, N]"))),
        {"name": "flash_bwd_f32 D 256 bias (K5 + K6 on f32 with a bias in one launch, the D 256 "
                 "form: f32 path A with heads of 256, mask arm, bias [4, 1, N, N], no dbias)",
         "route": "cuda", "source": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu",
         "replaces": split_replaces,
         "launches": f32_wide_train["path_a"]["mask"]["launches"]["bwd f32 d256"],
         **f32_wide["bwd_mask"]},
        {"name": "flash_bwd_f32 D 256 bias dbias (K5 + K6 on f32 with a bias and dbias in one "
                 "launch, the D 256 form: f32 path A with heads of 256, learned arm, bias [4, 8, "
                 "N, N])", "route": "cuda", "source": "flashattn_tpu_torch/csrc/flash_bwd_f32.cu",
         "replaces": split_replaces,
         "launches": f32_wide_train["path_a"]["learned"]["launches"]["bias bwd dbias"],
         **f32_wide["bwd_learned"]},
        # The bias routes' D 256 forms at the shape of path A with heads of 256
        # (B4 H8 N2048 D256; phase_wide_bias_check's timing), launches from its
        # fused steps (phase_wide_bias_train).
        *({"name": f"flash_fwd_bias_sm90 D 256 (K1's bias route's D 256 form, wgmma, the bias "
                   f"by TMA: path A with heads of 256, {arm} arm, bias {shape})",
           "route": "cuda", "source": bias_sm90_src,
           "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
           "launches": wide_bias_train[arm]["launches"]["K1 bias d256"],
           **wide_bias[f"k1_{arm}"]}
          for arm, shape in (("mask", "[4, 1, N, N]"), ("learned", "[4, 8, N, N]"))),
        *({"name": f"bwd_bias_sm90 D 256{' dbias' if arm == 'learned' else ''} (K5 + K6's bias "
                   f"route's D 256 form in one launch, wgmma, the bias from L2: path A with "
                   f"heads of 256, {arm} arm, bias {shape})",
           "route": "cuda", "source": bias_bwd_src, "replaces": split_replaces,
           "launches": wide_bias_train[arm]["launches"]["bias bwd d256"],
           **wide_bias[f"bwd_{arm}"]}
          for arm, shape in (("mask", "[4, 1, N, N]"), ("learned", "[4, 8, N, N]"))),
        # K1's quantized route: the quantized prefill and int8 K/V with SWA's
        # window, which no path of the port makes ("path" null; launches the
        # timing check's, counted from 0; phase_quant_check).
        *({"name": f"flash_fwd_quant_sm90 {name} (K1's quantized route, TMA + wgmma, the 8-bit "
                   f"tiles widened in shared memory: flash_attention_quantized causal prefill, "
                   f"B1 Hq16 Hkv8 N2048 D128)", "route": "cuda",
           "source": "flashattn_tpu_torch/csrc/flash_fwd_quant_sm90.cu",
           "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:516",
           "path": None, **quant[f"prefill_{name}"]}
          for name in ("int8", "fp8")),
        {"name": "flash_fwd_quant_sm90 int8 window (K1's quantized route, TMA + wgmma: int8 K/V "
                 "with SWA's window (2047, -1) causal, B1 Hq16 Hkv8 N8192 D128)", "route": "cuda",
         "source": "flashattn_tpu_torch/csrc/flash_fwd_quant_sm90.cu",
         "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:852",
         "path": None, **quant["swa_int8"]},
        # The f32 LM served from an 8-bit cache (phase_decode_f32): the decode
        # kernel's f32-q form at decode_step's call at cache 8192 held at
        # half (B8 Hq16 Hkv8 Nk4097 D128, folded), launches from the
        # requests and timed steps (its merge kernel's beside them).
        *({"name": f"flash_decode_quant_f32 {name} (K1's decode route's f32-q form, mma.sync: "
                   f"the f32 LM's decode_step on an {name} cache)", "route": "cuda",
           "source": "flashattn_tpu_torch/csrc/flash_decode_quant_f32.cu",
           "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
           "launches": dec_f32["counts"][name]["K1 decode f32"],
           "merge_launches": dec_f32["counts"][name]["K1 merge"], **dec_f32["rows"][name]}
          for name in ("int8", "fp8")),
        # The quantized route's f32-q form at the f32 LM's prefill (no path of
        # the port makes it: "path" null, launches the timing check's).
        *({"name": f"flash_fwd_quant_f32 {name} (K1's quantized route's f32-q form, TMA + wgmma, "
                   f"q in three bf16 pieces: f32 causal prefill on {name} K/V, B1 Hq16 Hkv8 N2048 "
                   f"D128)", "route": "cuda",
           "source": "flashattn_tpu_torch/csrc/flash_fwd_quant_f32.cu",
           "replaces": "flashattn_tpu/ops/flash_fwd.py:115, flashattn_tpu/ops/flash_fwd.py:516",
           "path": None, **quant[f"prefill_f32_{name}"]}
          for name in ("int8", "fp8"))]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
