"""The f32 routes' operand split: an f32 tensor as three bf16 pieces.

K1's f32 route (``csrc/flash_fwd_f32.cu``) and the f32 backward
(``csrc/flash_bwd_f32.cu``) compute every f32 product as the JAX kernels'
``Precision.HIGHEST`` does on the TPU's MXU (flashattn_tpu/ops/flash_fwd.py:
232-236): each operand is split into three bf16 pieces, x ≈ x0 + x1 + x2 with
x0 = bf16(x), x1 = bf16(x − x0), x2 = bf16(x − x0 − x1) (round to nearest
even), and a product a·b is the six bf16 products a0b0 + a0b1 + a1b0 + a0b2 +
a1b1 + a2b0 summed in f32. The split leaves ~2^-24 |x| and the dropped
products are 2^-24 of the product or less: f32's own class.

The split kernel (``csrc/split_bf16x3.cu``, which replaces no TPU kernel: on
the TPU the split happens inside the matrix unit) writes the pieces as the
attention kernels TMA-load them; the f32 kernels' C entries launch it once
before their attention kernel, on Q, K and V (the backward: and dO), into
:func:`scratch`, whose parts :func:`operands` names. :func:`split_reference`
is its plain version, bit for bit. Inputs are finite with |x| below bf16's
largest value (3.39e38, past which x0 rounds to infinity). The wrappers
count the split's launches beside their own: ``flash_fwd.fwd.launches_split``
and ``flash_bwd._f32_bwd_launch.launches_split``.
"""

from __future__ import annotations

import torch

PIECES = 3


def d_box(D: int) -> int:
    """The head-dim box of the pieces: the attention kernels' instantiation,
    64, 128 or 256 columns (zeros past D)."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def split_reference(x: torch.Tensor) -> torch.Tensor:
    """The split kernel's plain version: ``x [B, H, N, D]`` (f32) as ``[3, B,
    H, N, d_box(D)]`` bf16 contiguous (piece p of batch b is batch ``p·B + b``
    of a ``[3B, H, N, d_box]`` tensor), piece p the bf16 rounding of what
    pieces 0..p-1 leave of x; zeros past D."""
    B, H, N, D = x.shape
    out = torch.zeros((PIECES, B, H, N, d_box(D)), dtype=torch.bfloat16, device=x.device)
    r = x.float()
    for p in range(PIECES):
        out[p, ..., :D] = r.bfloat16()
        r = r - out[p, ..., :D].float()  # exact in f32
    return out


def scratch(q_rows: int, kv_rows: int, D: int, device) -> torch.Tensor:
    """The bf16 scratch that the f32 kernels' C entries split their operands
    into: three pieces of ``d_box(D)`` columns for each of ``q_rows`` rows of
    Q (and dO) and ``kv_rows`` rows of K and of V (``csrc/flash_fwd_f32.cu``,
    ``csrc/flash_bwd_f32.cu``)."""
    return torch.empty(PIECES * d_box(D) * (q_rows + 2 * kv_rows), dtype=torch.bfloat16,
                       device=device)


def operands(pieces: torch.Tensor, shapes, D: int) -> list[torch.Tensor]:
    """The parts of a :func:`scratch` that a C entry's split wrote, in its
    order: for each operand's ``(B, H, N)`` in ``shapes`` (the forward: q, k
    and v; the backward: q, k, v and dO; k's and v's N being kv_valid_len) a
    ``[3, B, H, N, d_box(D)]`` view, laid out as :func:`split_reference`'s."""
    out, at = [], 0
    for B, H, N in shapes:
        n = PIECES * B * H * N * d_box(D)
        out.append(pieces[at:at + n].view(PIECES, B, H, N, d_box(D)))
        at += n
    if at != pieces.numel():
        raise ValueError(f"the operands take {at} of the scratch's {pieces.numel()} elements")
    return out
