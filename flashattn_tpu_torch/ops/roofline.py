"""Tensor-core peak-FLOPs probe: the CUDA kernel's wrapper and its plain version.

Port of flashattn_tpu/ops/roofline.py: kernel K10 (``_roofline_kernel``), a
loop of chained matrix products on operands held on chip, timed with the
chained-execution harness (``utils/timing.py``). The names keep the JAX API:
:func:`measure_mxu_peak_tflops` measures the rate of K10's ``mma.sync``
tensor-core loop (``csrc/roofline.cu``, whose header says how the
recurrence's feedback is kept inside each CTA's tile), and
:func:`measure_xla_matmul_peak_tflops` that of a chained ``torch.matmul``
(cuBLAS), as the JAX function times a chained XLA matmul outside Pallas.
Both take ``dtype=torch.float32`` as the JAX functions do: K10's f32 form
splits its panels once into three bf16 pieces and takes each f32 product as
six bf16 ``mma.sync`` (the rate of f32-accurate products, against the 989 /
6 = 165 TFLOP/s that the port's f32 bounds assume), and the chained
``torch.matmul`` runs in full f32 (TF32 off).
:func:`roofline_call` launches the kernel for CUDA tensors and computes the
plain :func:`roofline_reference` for CPU tensors; a CUDA tensor never
reaches the plain version.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.oracle import _full_f32_matmul
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.timing import time_chained

N_CHAINS = 4  # independent dependency chains, as in the JAX probe
MAX_SIZE = 1536  # K10 keeps a 32-row panel of a and a 32-column panel of b in shared memory
F32_MAX_SIZE = 512  # ... as three bf16 pieces each in its f32 form


def roofline_reference(a: torch.Tensor, b: torch.Tensor, *, iters: int) -> torch.Tensor:
    """Plain PyTorch K10: N_CHAINS chains of ``c <- a @ b + 1e-30 c``
    (``iters`` products each, in full f32), summed in the JAX order and cast
    to ``a.dtype``. This is the kernel's arithmetic; the JAX recurrence
    ``c <- (a + 1e-30 c) @ b`` gives the same numbers, since the 1e-30 c
    term never changes a bf16 ``a`` of unit scale."""
    af, bf = a.float(), b.float()
    cs = [torch.zeros((a.shape[0], b.shape[1]), device=a.device) for _ in range(N_CHAINS)]
    with _full_f32_matmul():
        for _ in range(iters):
            cs = [torch.addmm(c, af, bf, beta=1e-30) for c in cs]
    acc = cs[0]
    for c in cs[1:]:
        acc = acc + c
    return acc.to(a.dtype)


def _check_device(a: torch.Tensor) -> None:
    if a.device.type != "cuda":
        raise NotImplementedError(f"no K10 kernel for device {a.device}")


def roofline_call(a: torch.Tensor, b: torch.Tensor, *, iters: int, size: int) -> torch.Tensor:
    """K10: ``[size, size]`` in ``a.dtype``, the sum of N_CHAINS chains of
    ``iters`` chained products of ``a``, ``b`` (``[size, size]`` each). CPU
    tensors take :func:`roofline_reference`. CUDA tensors launch the kernel,
    which takes bf16 with ``size % 64 == 0`` and ``64 <= size <= 1536``, or
    f32 (its f32 form) up to ``F32_MAX_SIZE``; anything else raises.
    ``roofline_call.launches`` counts kernel launches,
    ``roofline_call.launches_f32`` those of the f32 form."""
    if tuple(a.shape) != (size, size) or tuple(b.shape) != (size, size):
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be ({size}, {size})")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"a and b differ: {a.dtype} on {a.device}, {b.dtype} on {b.device}")
    if int(iters) < 1:
        raise ValueError(f"iters must be positive, got {iters}")
    if a.device.type == "cpu":
        return roofline_reference(a, b, iters=int(iters))
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the CUDA K10 takes bfloat16 or float32, got {a.dtype}")
    _check_device(a)
    f32 = a.dtype == torch.float32
    top = F32_MAX_SIZE if f32 else MAX_SIZE
    if size % 64 or not 64 <= size <= top:
        raise NotImplementedError(
            f"the CUDA K10 takes {a.dtype} sizes that are multiples of 64 from 64 to {top}, "
            f"got {size} (ROADMAP queue 2, K10 options: larger f32 panels need the wgmma K10)")
    a, b = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
            else x.clone(memory_format=torch.contiguous_format) for x in (a, b))
    out = torch.empty((size, size), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        lib = native.kernels()
        rc = (lib.fa_roofline_f32 if f32 else lib.fa_roofline_bf16)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), size, int(iters),
            torch.cuda.current_stream(a.device).cuda_stream)
    native.check(rc, "roofline kernel launch")
    roofline_call.launches += 1
    roofline_call.launches_f32 += int(f32)
    return out


roofline_call.launches = 0
roofline_call.launches_f32 = 0


def _operands(size: int, dtype, device):
    gen = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.randn((size, size), generator=gen, device=device).to(dtype)
                 for _ in range(2))


def measure_mxu_peak_tflops(*, size: int = 512, iters: int = 1024, dtype=torch.bfloat16,
                            device="cuda") -> float:
    """Measured tensor-core TFLOP/s of K10's ``mma.sync`` loop on ``device``
    (the card by default): ``2·size³·iters·N_CHAINS`` FLOP per call over the
    median differenced time of chained calls (:func:`time_chained`), each
    call's output the next one's ``a``, as the JAX probe chains them. With
    ``dtype=torch.float32`` the FLOP are f32-accurate ones (K10's f32 form,
    six bf16 products each)."""
    a, b = _operands(size, dtype, device)

    def step(carry, b):
        return roofline_call(carry, b, iters=iters, size=size)

    t = time_chained(step, a, consts=(b,), iters=8, warmup_iters=2, repeats=2)
    return 2.0 * size ** 3 * iters * N_CHAINS / t / 1e12


def measure_xla_matmul_peak_tflops(*, size: int = 1024, dtype=torch.bfloat16, repeats: int = 5,
                                   device="cuda") -> float:
    """Tensor-core TFLOP/s of a chained ``torch.matmul`` (no kernel of this
    package) on ``device``: N_CHAINS independent chains
    ``c <- a @ b + 1e-30 c``, one batched call (``torch.baddbmm``, the 1e-30 c
    in its epilogue) per step, timed as :func:`measure_mxu_peak_tflops`; f32
    in full f32, TF32 off."""
    a, b = _operands(size, dtype, device)
    a4, b4 = (x.expand(N_CHAINS, size, size).contiguous() for x in (a, b))

    def step(c, a4, b4):
        return torch.baddbmm(c, a4, b4, beta=1e-30)

    c0 = torch.zeros((N_CHAINS, size, size), dtype=dtype, device=device)
    with _full_f32_matmul():
        t = time_chained(step, c0, consts=(a4, b4), iters=64, warmup_iters=16, repeats=repeats)
    return 2.0 * size ** 3 * N_CHAINS / t / 1e12
