"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernel from ``flashattn_tpu_torch/csrc/`` with nvcc, holds
it against its plain PyTorch version at the serving path's shapes, then serves
the port's main path -- Euler sampling over the SD1.5 U-Net at full width
(random weights from a seed, 64x64 latent, 77-token context) -- and checks
that the path went through the kernel. One line per phase; the last two lines
are a JSON object of the kernels' numbers and ``{"ok": true, "device": ...}``.
Exits non-zero, before printing any result, when there is no CUDA device or
when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

STEPS = 20
REQUESTS = 2
LATENT = 64        # SD1.5 at 512x512 pixels
CONTEXT_LEN = 77   # CLIP text tokens
O_TOL_NAME = "FWD_TOL[bf16]"
LSE_ATOL = 1e-3
REL_L2_LIMIT = 2e-2


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
    lib, _ = native.build()
    native.kernels()
    log("build", f"K1 built from {native.CSRC.relative_to(native.CSRC.parent.parent)} "
                 f"into {lib.name} in {time.perf_counter() - t0:.2f} s")


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
                           device="cuda")
        if bnhd:  # [B, N, H, D] memory, passed as [B, H, N, D] views (the U-Net's layout)
            q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
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
    log("kernel", f"slice shape B1 H8 N4096 D40 bf16: K1 {ms:.4f} ms, plain version "
                  f"{plain_ms:.4f} ms (median CUDA-event time)")
    return {"max_abs_err": slice_err, "ms": ms, "plain_ms": plain_ms}


def phase_slice() -> int:
    from flashattn_tpu_torch.models.diffusion import euler_sample
    from flashattn_tpu_torch.models.unet import UNetConfig, init_unet, unet_forward
    from flashattn_tpu_torch.ops import flash_fwd

    # zero_init=False: with SD's zero-init, proj_out and conv_out are zero and
    # attention could not change the output, so the comparison would prove nothing.
    cfg = dataclasses.replace(UNetConfig.sd15(), zero_init=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    unet = init_unet(cfg, gen, device="cuda")
    n_params = sum(p.numel() for p in unet.parameters())
    shape = (1, LATENT, LATENT, cfg.in_channels)
    x = torch.randn(shape, generator=gen, device="cuda")
    ctx = torch.randn((1, CONTEXT_LEN, cfg.context_dim), generator=gen, device="cuda")
    t = torch.full((1,), 500.0, device="cuda")
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
        g = torch.Generator(device="cuda").manual_seed(seed)
        requests.append((torch.randn((1, CONTEXT_LEN, cfg.context_dim), generator=g, device="cuda"),
                         torch.randn(shape, generator=g, device="cuda")))
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import flashattn_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_env()
    phase_build()
    k1 = phase_kernel_check()
    launches = phase_slice()
    print(json.dumps({"kernels": [{
        "name": "flash_fwd (K1)", "route": "cuda",
        "source": "flashattn_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "flashattn_tpu/ops/flash_fwd.py:115",
        "launches": launches, **k1}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
