"""Ring attention on the ring kernels K7 (forward step) and K8 (backward step).

Port of flashattn_tpu/parallel/ring_kernel.py: differentiable
sequence-parallel attention for long-context training. Each of P ranks holds
one contiguous chunk of Q and of K/V (``[B, H, N/P, D]``); the K/V chunks
rotate one rank to the right per step, and rank r merges the partial of the
chunk it holds at step s -- that of rank ``(r - s) mod P`` -- into its running
state by the LSE rule, with causal and window masks in GLOBAL positions.

The TPU kernel runs a device's whole ring in one launch and moves the chunks
by remote DMA from inside it. Here the host runs the ring:

* one K7 / K8 launch per live (rank, step): rank and step are host ints, so a
  chunk wholly outside the band (:func:`ring._chunk_needed`) is never
  launched, and the first and last live steps are flags of the launch (K7
  starts the state on the first and finalizes O and LSE on the last;
  ``csrc/ring_fwd.cu`` says how; ``csrc/ring_bwd.cu`` is K8);
* the rotation goes through a transport with two implementations:
  :class:`VirtualRanks` (P ranks' chunks in one process, a rotation is a
  ``copy_`` of each rank's slot into its right neighbour's landing slot) and
  :class:`ProcessGroupRing` (one rank per process, ``dist.batch_isend_irecv``
  to the right and from the left: gloo on the CPU, NCCL on the card);
* ordering, the form JAX's RDMA-before-compute (ring_kernel.py:156-161) takes
  here: step s + 1's K/V rotation is issued before step s's launches -- on a
  side stream, or on NCCL's own stream -- and step s + 1's launches wait for
  it through an event (``work.wait()`` for NCCL). Each rotation first waits
  for the launches already issued, which read the landing slot a step earlier.
  The f32 (dK, dV) accumulators, which each backward step writes, rotate after
  it, and take one final hop home (ring_kernel.py:427-444).

:func:`ring_attention_kernel` works on a rank's local chunks with a process
group; :func:`ring_attention_kernel_sharded` returns a callable on global
tensors that runs ``ranks`` virtual ranks in one process (the counterpart of
the JAX function on a virtual device mesh). CPU tensors take the plain
versions of the steps, :func:`ring_fwd_step_reference` and
:func:`ring_bwd_step_reference`; CUDA tensors launch the kernels or raise.
The kernels take bf16 and f32 (the JAX kernel's ``Precision.HIGHEST``, as
K1's f32 route computes it: each operand as three bf16 pieces,
``ops/f32_split.py``) at every head dim up to 256; the entry points pad a
head dim that is not a multiple of 8 with zeros, as ``flash_attention`` does.
The ``FLASHATTN_TPU_RING_BWD_KERNEL`` fallback to the ppermute ring is not
ported (the ``FLASHATTN_TPU_*`` knobs are left out by decision, ROADMAP).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from flashattn_tpu_torch.ops import f32_split
from flashattn_tpu_torch.ops.flash import _dispatch_dtype
from flashattn_tpu_torch.ops.flash_fwd import check_window, kernel_window
from flashattn_tpu_torch.ops.oracle import (
    DEFAULT_MASK_VALUE,
    _expand_kv,
    _full_f32_matmul,
    position_mask,
)
from flashattn_tpu_torch.parallel.ring import _chunk_needed, _perm
from flashattn_tpu_torch.utils import native

LOG2E = 1.0 / math.log(2.0)
LN2 = math.log(2.0)
# Rows whose chunk max never rose above this are fully masked: their partial
# carries no probability mass and is dropped at merge time.
_NEG_GUARD = DEFAULT_MASK_VALUE * 0.5
MAX_HEAD_DIM = 256


def _block_sizes(nq: int, nk: int) -> tuple[int, int]:
    """The JAX kernel's tile sizes, which fix the chunk contract of
    :func:`supported` (the CUDA kernels tile by 128 rows inside them)."""
    return min(512, nq), min(512, nk)


def supported(nq: int, nk: int, d: int, window) -> bool:
    """Whether local chunks of ``nq`` / ``nk`` rows take the ring kernels:
    multiples of 128 (and of the JAX tile sizes), with or without a window."""
    del d, window
    bq, bk = _block_sizes(nq, nk)
    return nq % bq == 0 and nk % bk == 0 and nq % 128 == 0 and nk % 128 == 0


# ---------------------------------------------------------------------------
# One step of one rank: the kernels' plain versions and their wrappers.


def _step_scores(q2, kf, *, q_base, kv_off, causal, window):
    """``Q2 Kᵀ`` in f32 (log2 units: q2 carries scale·log2e) for ``kf``
    expanded to the query heads, the pairs outside the band in global
    positions set to the mask value; and the keep mask."""
    keep = position_mask(q2.shape[2], kf.shape[2], q_offset=q_base, kv_offset=kv_off,
                         causal=causal, window=window, device=q2.device)
    with _full_f32_matmul():
        s2 = torch.matmul(q2.float(), kf.transpose(-1, -2))
    return torch.where(keep, s2, torch.full_like(s2, DEFAULT_MASK_VALUE)), keep


def ring_fwd_step_reference(q2, k, v, acc, m, l, o, lse, *, q_base: int, kv_off: int,
                            causal: bool = False, window=None, first: bool = False,
                            last: bool = False) -> None:
    """Plain PyTorch K7, in place: the chunk partial of ``q2`` ``[B,Hq,nq,D]``
    (q·scale·log2e) against ``k``/``v`` ``[B,Hkv,nk,D]`` at global rows
    ``q_base ..`` and columns ``kv_off ..`` -- rowmax ``m_c``, ``l_c =
    Σ exp2(S2 − m_c)``, ``acc_c = exp2(S2 − m_c) V`` -- merged into the f32
    state ``acc [B,Hq,nq,D]``, ``m``, ``l`` ``[B,Hq,nq]`` (m in log2 units)
    by ring_kernel.py:342-347, a partial whose max is at or below half the
    mask value dropped. ``first``: start from (mask, 0, 0) without reading the
    state (which may be None with ``last``); ``last``: write ``o`` (``O =
    acc / l``, 0 on a row no step gave a key) and ``lse`` (``(m + log2 l)
    ln2``, −inf on such a row) instead of the state."""
    kf, vf = _expand_kv(k, v, q2.shape[1])
    s2, _ = _step_scores(q2, kf, q_base=q_base, kv_off=kv_off, causal=causal, window=window)
    m_c = s2.amax(dim=-1)
    p = torch.exp2(s2 - m_c[..., None])
    with _full_f32_matmul():
        acc_c = torch.matmul(p, vf)
    l_c = p.sum(dim=-1)
    if first:
        m_run = torch.full_like(m_c, DEFAULT_MASK_VALUE)
        l_run, acc_run = torch.zeros_like(l_c), torch.zeros_like(acc_c)
    else:
        m_run, l_run, acc_run = m, l, acc
    m_new = torch.maximum(m_run, m_c)
    zero = torch.zeros_like(m_new)
    a_run = torch.where(m_run <= _NEG_GUARD, zero, torch.exp2(m_run - m_new))
    a_c = torch.where(m_c <= _NEG_GUARD, zero, torch.exp2(m_c - m_new))
    l_new = l_run * a_run + l_c * a_c
    acc_new = acc_run * a_run[..., None] + acc_c * a_c[..., None]
    if last:
        alive = l_new > 0
        safe = torch.where(alive, l_new, torch.ones_like(l_new))
        o.copy_(torch.where(alive[..., None], acc_new / safe[..., None], torch.zeros_like(acc_new)))
        lse.copy_(torch.where(alive, (m_new + torch.log2(safe)) * LN2,
                              torch.full_like(l_new, -math.inf)))
    else:
        acc.copy_(acc_new)
        m.copy_(m_new)
        l.copy_(l_new)


def ring_bwd_step_reference(q2, k, v, do, lse, delta, dq, dk, dv, *, q_base: int, kv_off: int,
                            causal: bool = False, window=None) -> None:
    """Plain PyTorch K8, in place: with the GLOBAL ``lse`` (natural log, −inf
    on a dead row) and ``delta`` = rowsum(dO·O) ``[B,Hq,nq]``, P = exp2(S2 −
    lse·log2e), exactly 0 outside the band and on dead rows, dS = P (dP − Δ)
    with dP = dO Vᵀ (the algebra of ring.py:66-128), and ``dq += dS K``,
    ``dk += dSᵀ Q2``, ``dv += Pᵀ dO``, dK/dV summed over the query heads of
    each KV head. ``dq`` ``[B,Hq,nq,D]`` and ``dk``/``dv`` ``[B,Hkv,nk,D]``
    are f32 and come out ×1/scale and ×1/ln2 of the gradients: q2 carries
    scale·log2e (ring_kernel.py:726, :934)."""
    B, Hq, _, D = q2.shape
    Hkv, nk = k.shape[1], k.shape[2]
    kf, vf = _expand_kv(k, v, Hq)
    s2, keep = _step_scores(q2, kf, q_base=q_base, kv_off=kv_off, causal=causal, window=window)
    lse2 = lse.float() * LOG2E
    keep = keep & (lse2 > _NEG_GUARD)[..., None]
    p = torch.where(keep, torch.exp2(s2 - lse2[..., None]), torch.zeros_like(s2))
    q2f, dof = q2.float(), do.float()
    with _full_f32_matmul():
        ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta.float()[..., None])
        dq.add_(torch.matmul(ds, kf))
        dk.add_(torch.matmul(ds.transpose(-1, -2), q2f).view(B, Hkv, Hq // Hkv, nk, D).sum(2))
        dv.add_(torch.matmul(p.transpose(-1, -2), dof).view(B, Hkv, Hq // Hkv, nk, D).sum(2))


def _check_kernel_args(q, name: str) -> None:
    """Raise for what the CUDA ring kernels (K7, K8) do not take."""
    B, Hq, _, D = q.shape
    if q.device.type != "cuda":
        raise NotImplementedError(f"no {name} kernel for device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the CUDA {name} takes bfloat16 and float32, got {q.dtype}")
    if D % 8 or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA {name} takes head dims that are multiples of 8 up to {MAX_HEAD_DIM}, "
            f"got D={D} (ROADMAP queue 2, 'also open: options')")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must each be at most 65535 (CUDA grid limit)")


def _check_step_args(name: str, q2, k, v, same, f32) -> None:
    """Raise unless a step's tensors are as its kernel addresses them: q2
    ``[B, Hq, nq, D]`` bf16 or f32, k and v ``[B, Hkv, nk, D]`` with one set
    of strides, they and the ``same`` tensors (name: tensor, q2's shape) in
    q2's dtype with a unit head-dim stride, other strides on 8-element
    boundaries and nonzero on dims of extent > 1, and a 16-byte-aligned
    address (what a TMA map takes: a rank's chunk view of a global tensor
    passes as it is; the f32 forms' split reads them as well), the ``f32``
    buffers (name: (tensor or None, shape)) f32, contiguous and 16-byte
    aligned (the kernels' bulk copies), all on q2's device. Nothing is
    copied: the outputs are written in place."""
    B, Hq, nq, D = q2.shape
    if (k.shape != v.shape or k.ndim != 4 or k.shape[0] != B or k.shape[3] != D
            or Hq % k.shape[1] or k.stride() != v.stride()):
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} (strides "
                         f"{k.stride()}, {v.stride()}) do not fit q2 {tuple(q2.shape)}")
    for key, x in {"q2": q2, "k": k, "v": v, **same}.items():
        if (x.dtype != q2.dtype or x.dtype not in (torch.bfloat16, torch.float32)
                or x.device != q2.device or (key not in ("k", "v") and x.shape != q2.shape)):
            raise ValueError(f"{name}: {key} {x.dtype} {tuple(x.shape)} on {x.device}, "
                             f"q2 {tuple(q2.shape)} on {q2.device}")
        if not (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
                and all(st % 8 == 0 and (st or n == 1)
                        for st, n in zip(x.stride()[:3], x.shape[:3]))):
            raise ValueError(f"{name}: {key} strides {x.stride()} or address break the "
                             "kernel's 16-byte loads (its TMA boxes)")
    for key, (x, shape) in f32.items():
        if x is not None and (x.dtype != torch.float32 or tuple(x.shape) != shape
                              or not x.is_contiguous() or x.device != q2.device
                              or x.data_ptr() % 16):
            raise ValueError(f"{name}: {key} must be contiguous f32 {shape}, 16-byte aligned, "
                             f"on {q2.device}, got {x.dtype} {tuple(x.shape)}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _piece_args(pieces) -> tuple:
    """The f32 C entries' pieces arguments from ``(q_pieces, kv_pieces,
    split_q)``; none for bf16 (``pieces`` None)."""
    if pieces is None:
        return ()
    q_pieces, kv_pieces, split_q = pieces
    return q_pieces.data_ptr(), kv_pieces.data_ptr(), int(bool(split_q))


def _launch_fwd(lib, q2, k, v, acc, m, l, o, lse, *, q_base, kv_off, causal, window, first,
                last, stream, pieces=None) -> int:
    """Call the C entry of one K7 launch with its arguments in its order:
    ``lib.fa_ring_fwd_bf16`` (``native.RING_FWD_ARGTYPES``) or, with
    ``pieces`` (an f32 step's ``(q_pieces, kv_pieces, split_q)``),
    ``lib.fa_ring_fwd_f32`` (``native.RING_FWD_F32_ARGTYPES``); returns its
    cudaError_t."""
    B, Hq, nq, D = q2.shape
    entry = lib.fa_ring_fwd_bf16 if pieces is None else lib.fa_ring_fwd_f32
    return entry(
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(acc), _ptr(m), _ptr(l), o.data_ptr(),
        lse.data_ptr(), *_piece_args(pieces), B, Hq, k.shape[1], nq, k.shape[2], D,
        int(q_base), int(kv_off), int(bool(causal)), *kernel_window(window), int(bool(first)),
        int(bool(last)), *q2.stride()[:3], *k.stride()[:3], *o.stride()[:3], stream)


def _launch_bwd(lib, q2, k, v, do, lse, delta, dq, dk, dv, *, q_base, kv_off, causal, window,
                stream, pieces=None) -> int:
    """Call the C entry of one K8 launch with its arguments in its order:
    ``lib.fa_ring_bwd_bf16`` (``native.RING_BWD_ARGTYPES``) or, with
    ``pieces``, ``lib.fa_ring_bwd_f32`` (``native.RING_BWD_F32_ARGTYPES``);
    returns its cudaError_t."""
    B, Hq, nq, D = q2.shape
    entry = lib.fa_ring_bwd_bf16 if pieces is None else lib.fa_ring_bwd_f32
    return entry(
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_piece_args(pieces), B,
        Hq, k.shape[1], nq, k.shape[2], D, int(q_base), int(kv_off), int(bool(causal)),
        *kernel_window(window), *q2.stride()[:3], *k.stride()[:3], *do.stride()[:3], stream)


def q_pieces_scratch(q2, operands: int):
    """The bf16 scratch that holds a rank's f32 q2 (``operands`` 2: and dO)
    as three bf16 pieces each, ``[operands, 3, B, Hq, nq, d_box(D)]`` flat,
    across the K7 / K8 launches of one ring: q and dO do not rotate, so the
    rank's first live step splits them into it and its later steps read it."""
    B, Hq, nq, D = q2.shape
    return torch.empty(operands * f32_split.PIECES * B * Hq * nq * f32_split.d_box(D),
                       dtype=torch.bfloat16, device=q2.device)


def _f32_pieces(q2, k, q_pieces, split_q: bool, operands: int) -> tuple:
    """An f32 step's pieces: ``q_pieces`` checked (or made, and then split
    into), and this step's K/V pieces, ``[2, 3, B, Hkv, nk, d_box(D)]``
    flat, which its launch splits k and v into (they rotate as f32)."""
    B, Hq, nq, D = q2.shape
    n_q = operands * f32_split.PIECES * B * Hq * nq * f32_split.d_box(D)
    if q_pieces is None:
        q_pieces, split_q = q_pieces_scratch(q2, operands), True
    elif (q_pieces.dtype != torch.bfloat16 or q_pieces.numel() != n_q
          or not q_pieces.is_contiguous() or q_pieces.device != q2.device
          or q_pieces.data_ptr() % 16):
        raise ValueError(f"q_pieces must be {n_q} contiguous bf16 elements, 16-byte aligned, on "
                         f"{q2.device}, got {q_pieces.dtype} {tuple(q_pieces.shape)}")
    kv = torch.empty(2 * f32_split.PIECES * k.shape[0] * k.shape[1] * k.shape[2]
                     * f32_split.d_box(D), dtype=torch.bfloat16, device=q2.device)
    return q_pieces, kv, split_q


def _count(step, q2, pieces) -> None:
    """One launch of ``step``'s kernel: every launch, the f32 forms' (with
    the split their C entry launches before the kernel) and the D 256
    forms' (D above 128)."""
    step.launches += 1
    step.launches_f32 += pieces is not None
    step.launches_split += pieces is not None
    step.launches_d256 += q2.shape[-1] > 128


def ring_fwd_step(q2, k, v, acc, m, l, o, lse, *, q_base: int, kv_off: int,
                  causal: bool = False, window=None, first: bool = False,
                  last: bool = False, q_pieces=None, split_q: bool = True) -> None:
    """K7: one forward ring step of one rank, in place (arguments as
    :func:`ring_fwd_step_reference`). CPU tensors take the plain version;
    CUDA tensors launch the kernel -- bf16 or f32, D ≤ 256 a multiple of 8,
    chunks of multiples of 128 rows, q2 / k / v / o as a TMA map takes them
    (:func:`_check_step_args`), ``acc``/``m``/``l``/``lse`` contiguous,
    ``k`` and ``v`` with one set of strides -- or raise. On f32 the C entry
    first splits k and v into three bf16 pieces each, and q2 into
    ``q_pieces`` (:func:`q_pieces_scratch`) with ``split_q``; without
    ``split_q`` the step reads the pieces that an earlier step of the rank
    wrote there; ``q_pieces=None``: the step makes its own and splits q2.
    ``ring_fwd_step.launches`` counts kernel launches (``launches_f32``,
    ``launches_d256`` those of the f32 and D 256 forms, ``launches_split``
    the splits the f32 C entry launches, one each)."""
    if q2.device.type == "cpu":
        return ring_fwd_step_reference(q2, k, v, acc, m, l, o, lse, q_base=q_base,
                                       kv_off=kv_off, causal=causal, window=window,
                                       first=first, last=last)
    _check_kernel_args(q2, "K7")
    B, Hq, nq, D = q2.shape
    stats = (B, Hq, nq)
    _check_step_args("K7", q2, k, v, {"o": o}, {
        "acc": (acc, (*stats, D)), "m": (m, stats), "l": (l, stats), "lse": (lse, stats)})
    if not (first and last) and (acc is None or m is None or l is None):
        raise ValueError("K7: a step that is not both the first and the last reads or "
                         "writes the state acc, m, l")
    pieces = (_f32_pieces(q2, k, q_pieces, split_q, 1) if q2.dtype == torch.float32 else None)
    with torch.cuda.device(q2.device):
        rc = _launch_fwd(native.kernels(), q2, k, v, acc, m, l, o, lse, q_base=q_base,
                         kv_off=kv_off, causal=causal, window=window, first=first, last=last,
                         stream=torch.cuda.current_stream(q2.device).cuda_stream, pieces=pieces)
    native.check(rc, "ring_fwd kernel launch")
    _count(ring_fwd_step, q2, pieces)


def ring_bwd_step(q2, k, v, do, lse, delta, dq, dk, dv, *, q_base: int, kv_off: int,
                  causal: bool = False, window=None, q_pieces=None,
                  split_q: bool = True) -> None:
    """K8: one backward ring step of one rank, in place (arguments as
    :func:`ring_bwd_step_reference`). CPU tensors take the plain version;
    CUDA tensors launch the kernel (as :func:`ring_fwd_step`, ``q_pieces``
    holding q2's pieces and then dO's; ``dq`` is added to by the kernel's
    bulk reductions and must start at 0) or raise.
    ``ring_bwd_step.launches`` counts kernel launches (and the same
    ``launches_f32``, ``launches_d256`` and ``launches_split``)."""
    if q2.device.type == "cpu":
        return ring_bwd_step_reference(q2, k, v, do, lse, delta, dq, dk, dv, q_base=q_base,
                                       kv_off=kv_off, causal=causal, window=window)
    _check_kernel_args(q2, "K8")
    B, Hq, nq, D = q2.shape
    stats = (B, Hq, nq)
    _check_step_args("K8", q2, k, v, {"do": do}, {
        "lse": (lse, stats), "delta": (delta, stats), "dq": (dq, (*stats, D)),
        "dk": (dk, tuple(k.shape)), "dv": (dv, tuple(k.shape))})
    pieces = (_f32_pieces(q2, k, q_pieces, split_q, 2) if q2.dtype == torch.float32 else None)
    with torch.cuda.device(q2.device):
        rc = _launch_bwd(native.kernels(), q2, k, v, do, lse, delta, dq, dk, dv, q_base=q_base,
                         kv_off=kv_off, causal=causal, window=window,
                         stream=torch.cuda.current_stream(q2.device).cuda_stream, pieces=pieces)
    native.check(rc, "ring_bwd kernel launch")
    _count(ring_bwd_step, q2, pieces)


for _step in (ring_fwd_step, ring_bwd_step):
    _step.launches = _step.launches_f32 = _step.launches_d256 = _step.launches_split = 0


# ---------------------------------------------------------------------------
# Transports: who holds which chunks, and how a rotation moves them.


class VirtualRanks:
    """``world`` ranks of the ring in one process: rank r's chunk of a global
    ``[B, H, N, ...]`` tensor is the view of its rows ``[r N/P, (r+1) N/P)``.
    A rotation copies each rank's tensors into its right neighbour's landing
    slot (``tag`` tells only a process group's messages apart); on the card
    it runs on a side stream and returns the event that the next step's
    launches wait on."""

    def __init__(self, world: int):
        if world < 1:
            raise ValueError(f"a ring needs at least one rank, got {world}")
        self.world = world
        self.ranks = tuple(range(world))
        self._streams = {}

    def split(self, x):
        n = x.shape[2] // self.world
        return [x.narrow(2, r * n, n) for r in self.ranks]

    def join(self, xs):
        return torch.cat(xs, dim=2)

    def rotate(self, srcs, dsts, tag: int = 0):
        def copies():
            for i, j in _perm(self.world):
                for s, d in zip(srcs[i], dsts[j]):
                    d.copy_(s)

        dev = srcs[0][0].device
        if dev.type != "cuda":
            copies()
            return None
        side = self._streams.setdefault(dev, torch.cuda.Stream(dev))
        side.wait_stream(torch.cuda.current_stream(dev))  # the landing slots are read
        with torch.cuda.stream(side):
            copies()
            done = torch.cuda.Event()
            done.record(side)
        return dev, done

    def wait(self, handle) -> None:
        if handle is not None:
            dev, done = handle
            torch.cuda.current_stream(dev).wait_event(done)


class ProcessGroupRing:
    """This process's rank of a ring over a ``torch.distributed`` process
    group (``group=None``: the default group; without an initialised default
    group, a ring of one). A rotation sends this rank's tensors to the right
    neighbour and receives the left one's into the landing slot with
    ``dist.batch_isend_irecv`` -- gloo for CPU tensors, NCCL on the card,
    where the collective stream first waits for the launches already issued
    and ``wait`` makes the next launches wait for the transfer."""

    def __init__(self, group=None):
        if group is None and not dist.is_initialized():
            self.group, self.world, rank = None, 1, 0
        else:
            self.group = group
            self.world, rank = dist.get_world_size(group), dist.get_rank(group)
        self.ranks = (rank,)
        if self.world > 1:
            ring = group if group is not None else dist.group.WORLD
            self._right = dist.get_global_rank(ring, (rank + 1) % self.world)
            self._left = dist.get_global_rank(ring, (rank - 1) % self.world)

    def split(self, x):
        return [x]

    def join(self, xs):
        return xs[0]

    def rotate(self, srcs, dsts, tag: int = 0):
        (src,), (dst,) = srcs, dsts
        ops = [dist.P2POp(dist.isend, t, self._right, self.group, tag + j)
               for j, t in enumerate(src)]
        ops += [dist.P2POp(dist.irecv, t, self._left, self.group, tag + j)
                for j, t in enumerate(dst)]
        return dist.batch_isend_irecv(ops)

    def wait(self, works) -> None:
        for w in works:
            w.wait()


# ---------------------------------------------------------------------------
# The ring.


def _live_steps(rank: int, world: int, nq: int, nk: int, causal: bool, window) -> list[int]:
    """The steps at which ``rank`` holds a chunk that its rows attend."""
    return [s for s in range(world)
            if _chunk_needed(rank * nq, (rank - s) % world * nk, nq, nk, causal, window)]


def _ring_pieces(step, q2s, operands: int):
    """``pieces(i, first)``: the keyword arguments that rank i's step takes
    beside the ring's -- on the f32 kernels (``step`` None, f32 tensors off
    the CPU) the rank's :func:`q_pieces_scratch`, which its first live step
    splits q2 (and dO) into and its later steps read; else none."""
    q2 = q2s[0]
    if step is not None or q2.dtype != torch.float32 or q2.device.type == "cpu":
        return lambda i, first: {}
    scratch = [q_pieces_scratch(x, operands) for x in q2s]
    return lambda i, first: dict(q_pieces=scratch[i], split_q=first)


def _ring_forward(xport, q2s, ks, vs, os, *, causal, window, step=None):
    """Run the forward ring over the local ranks of ``xport``: per rank its
    q2 (q·scale·log2e), k, v chunks and an output view ``o``. Writes each
    ``o`` in place and returns each rank's LSE ``[B, Hq, nq]`` (natural log,
    −inf on a row no chunk gave a key). ``step`` (default K7's wrapper) runs
    one (rank, step)."""
    pieces = _ring_pieces(step, q2s, 1)
    step = step or ring_fwd_step
    P = xport.world
    B, Hq, nq, D = q2s[0].shape
    nk = ks[0].shape[2]
    f32 = dict(dtype=torch.float32, device=q2s[0].device)
    lses = [torch.empty((B, Hq, nq), **f32) for _ in q2s]
    live = [_live_steps(r, P, nq, nk, causal, window) for r in xport.ranks]
    state = [(torch.empty((B, Hq, nq, D), **f32), torch.empty((B, Hq, nq), **f32),
              torch.empty((B, Hq, nq), **f32)) if len(steps) > 1 else (None, None, None)
             for steps in live]
    kv_shape = dict(size=ks[0].shape, dtype=ks[0].dtype, device=ks[0].device)
    slots = [[(torch.empty(**kv_shape), torch.empty(**kv_shape)) for _ in range(2)]
             for _ in q2s] if P > 1 else None
    cur = list(zip(ks, vs))
    for s in range(P):
        if s < P - 1:  # step s + 1's chunks move while step s computes
            nxt = [sl[(s + 1) % 2] for sl in slots]
            moving = xport.rotate(cur, nxt)
        for i, r in enumerate(xport.ranks):
            if s in live[i]:
                step(q2s[i], *cur[i], *state[i], os[i], lses[i], q_base=r * nq,
                     kv_off=(r - s) % P * nk, causal=causal, window=window,
                     first=s == live[i][0], last=s == live[i][-1],
                     **pieces(i, s == live[i][0]))
        if s < P - 1:
            xport.wait(moving)
            cur = nxt
    for i, steps in enumerate(live):
        if not steps:  # no chunk in reach of any row
            os[i].zero_()
            lses[i].fill_(-math.inf)
    return lses


def _ring_backward(xport, q2s, ks, vs, dos, lses, deltas, *, causal, window, step=None):
    """Run the backward ring: the K/V chunks rotate ahead of each step as in
    the forward; each rank's f32 (dK, dV) accumulator for the chunk it holds
    rotates with it after the step that adds to it, and the last rotation
    brings every accumulator home. Returns per rank (dQ, dK, dV) in f32,
    ×1/scale, ×1/ln2 and ×1 of the gradients. ``step`` defaults to K8's
    wrapper."""
    pieces = _ring_pieces(step, q2s, 2)
    step = step or ring_bwd_step
    P = xport.world
    B, Hq, nq, D = q2s[0].shape
    nk = ks[0].shape[2]
    f32 = dict(dtype=torch.float32, device=q2s[0].device)
    kv_shape = dict(size=ks[0].shape, dtype=ks[0].dtype, device=ks[0].device)
    acc_shape = dict(size=ks[0].shape, **f32)
    dqs = [torch.zeros((B, Hq, nq, D), **f32) for _ in q2s]
    acc = [[(torch.zeros(**acc_shape), torch.zeros(**acc_shape))]
           + ([(torch.empty(**acc_shape), torch.empty(**acc_shape))] if P > 1 else [])
           for _ in q2s]
    slots = [[(torch.empty(**kv_shape), torch.empty(**kv_shape)) for _ in range(2)]
             for _ in q2s] if P > 1 else None
    live = [_live_steps(r, P, nq, nk, causal, window) for r in xport.ranks]
    cur = list(zip(ks, vs))
    for s in range(P):
        if s < P - 1:
            nxt = [sl[(s + 1) % 2] for sl in slots]
            moving = xport.rotate(cur, nxt)
        held = [a[s % 2] for a in acc]
        for i, r in enumerate(xport.ranks):
            if s in live[i]:
                step(q2s[i], *cur[i], dos[i], lses[i], deltas[i], dqs[i], *held[i],
                     q_base=r * nq, kv_off=(r - s) % P * nk, causal=causal, window=window,
                     **pieces(i, s == live[i][0]))
        if P > 1:  # after the step that wrote them; at s = P - 1, the hop home
            xport.wait(xport.rotate(held, [a[(s + 1) % 2] for a in acc], tag=len(cur[0])))
        if s < P - 1:
            xport.wait(moving)
            cur = nxt
    home = [a[P % 2 if P > 1 else 0] for a in acc]
    return dqs, [h[0] for h in home], [h[1] for h in home]


def _prescale(q, scale: float):
    """q·scale·log2e in q's dtype (ring_kernel.py:886)."""
    return (q.float() * (scale * LOG2E)).to(q.dtype)


def _ring_grads(xport, q2, k, v, o, lses, do, *, scale, causal, window, step=None):
    """dQ, dK, dV in the inputs' dtypes from the saved forward: Δ =
    rowsum(dO·O) in f32 (ring_kernel.py:916), the backward ring, then dQ·scale
    and dK·ln2 (ring_kernel.py:934-936)."""
    do = do.to(q2.dtype).contiguous()
    delta = (do.float() * o.float()).sum(-1)
    dqs, dks, dvs = _ring_backward(
        xport, xport.split(q2), xport.split(k), xport.split(v), xport.split(do), lses,
        [d.contiguous() for d in xport.split(delta)], causal=causal, window=window, step=step)
    return ((xport.join(dqs) * scale).to(q2.dtype), (xport.join(dks) * LN2).to(k.dtype),
            xport.join(dvs).to(v.dtype))


class _RingKernelCore(torch.autograd.Function):
    """The forward ring on K7 saving ``(q2, k, v, o)`` and each rank's LSE;
    the backward ring on K8 (the JAX ``_ring_kernel_core`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, xport, causal, scale, window):
        q2 = _prescale(q, scale)
        o = torch.empty_like(q)
        lses = _ring_forward(xport, xport.split(q2), xport.split(k), xport.split(v),
                             xport.split(o), causal=causal, window=window)
        ctx.save_for_backward(q2, k, v, o, *lses)
        ctx.xport, ctx.causal, ctx.scale, ctx.window = xport, causal, scale, window
        return o

    @staticmethod
    def backward(ctx, g):
        q2, k, v, o, *lses = ctx.saved_tensors
        dq, dk, dv = _ring_grads(ctx.xport, q2, k, v, o, lses, g, scale=ctx.scale,
                                 causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def _check_chunks(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q/k/v must be rank-4, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} incompatible with q "
                         f"{tuple(q.shape)}")
    if not supported(q.shape[2], k.shape[2], q.shape[3], window):
        raise ValueError(f"ring kernel route needs 128-aligned local chunks, got "
                         f"nq={q.shape[2]} nk={k.shape[2]}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq={q.shape[1]} must be a multiple of Hkv={k.shape[1]}")


def _pad_d(*xs):
    """``xs`` with the head dim zero-padded to a multiple of 8 (the kernels'
    TMA boxes' unit; the JAX kernel pads to 64, ring_kernel.py:882-896):
    zero columns of q and k add 0 to every score and zero columns of v give
    zero columns of O, which the callers slice off."""
    pad = -xs[0].shape[-1] % 8
    return tuple(torch.nn.functional.pad(x, (0, pad)) if pad else x for x in xs)


def _apply(q, k, v, xport, *, causal, scale, window):
    """Dtype dispatch (fp16 runs as bf16), the head dim padded to a multiple
    of 8 (the scale stays the true D's), checks, and the autograd ring."""
    window = check_window(window)
    D = q.shape[-1]
    if scale is None:
        scale = float(D) ** -0.5
    kdt = _dispatch_dtype(q.dtype)
    in_dtype = q.dtype
    q, k, v = _pad_d(*(x.to(kdt).contiguous() for x in (q, k, v)))
    if q.device.type == "cuda":
        _check_kernel_args(q, "K7/K8")
    o = _RingKernelCore.apply(q, k, v, xport, bool(causal), float(scale), window)
    return o[..., :D].to(in_dtype)


def ring_attention_kernel(q, k, v, *, group=None, causal: bool = False,
                          scale: float | None = None, window=None):
    """Ring attention on the ring kernels, on this rank's local chunks.

    ``q`` ``[B, Hq, N/P, D]`` and ``k``/``v`` ``[B, Hkv, N/P, D]`` are the
    chunks of the global sequence that this rank of ``group`` holds (rank
    and world size come from the group; ``group=None`` is the default group,
    or a ring of one when ``torch.distributed`` is not initialised): rank r
    holds rows ``[r N/P, (r+1) N/P)``. Chunks must be multiples of 128 rows
    (``ValueError`` naming "128-aligned" otherwise) and Hkv must divide Hq
    (GQA). ``causal`` and ``window = (left, right)`` mask in global
    positions. bf16 and f32 run as they are, fp16 as bf16; any head dim up
    to 256 (on the card, one above 256 raises NotImplementedError).
    Differentiable: the backward runs the ring again and every rank of the
    group must take part, as in the forward. Returns the local chunk of the
    output, in q's dtype.
    """
    _check_chunks(q, k, v, window)
    return _apply(q, k, v, ProcessGroupRing(group), causal=causal, scale=scale, window=window)


def ring_attention_kernel_sharded(*, ranks: int, causal: bool = False,
                                  scale: float | None = None, window=None):
    """A callable on global ``[B, H, N, D]`` tensors that runs ring attention
    over ``ranks`` virtual ranks in one process: rank r holds rows ``[r
    N/ranks, (r+1) N/ranks)`` of q, k and v, and the K/V chunks rotate by
    copies between the ranks' slots (on a side stream on the card).
    Differentiable; arguments as :func:`ring_attention_kernel`. The
    counterpart of the JAX function on a device mesh."""
    xport = VirtualRanks(ranks)

    def call(q, k, v):
        if q.ndim != 4 or q.shape[2] % ranks or k.ndim != 4 or k.shape[2] % ranks:
            raise ValueError(f"global sequences {tuple(q.shape)} / {tuple(k.shape)} do not "
                             f"split into {ranks} chunks")
        _check_chunks(*(x.narrow(2, 0, x.shape[2] // ranks) for x in (q, k, v)), window)
        return _apply(q, k, v, xport, causal=causal, scale=scale, window=window)

    return call


def run_virtual_ring(q, k, v, do=None, *, ranks: int, causal: bool = False,
                     scale: float | None = None, window=None, plain: bool = False):
    """The ring over ``ranks`` virtual ranks without autograd, for checks and
    timing: ``(O, LSE)`` (LSE ``[B, Hq, N]`` f32, natural log) and, with
    ``do``, ``(O, LSE, dQ, dK, dV)``, all on the inputs' dtype (``q``, ``k``
    and ``v`` in one dtype, chunk-aligned; a head dim that is not a
    multiple of 8 runs zero-padded). ``plain=True`` runs the same
    rotation with the steps' plain versions in place of the kernels -- the
    plain ring, on any device."""
    window = check_window(window)
    D = q.shape[-1]
    if scale is None:
        scale = float(D) ** -0.5
    xport = VirtualRanks(ranks)
    q, k, v = _pad_d(*(x.contiguous() for x in (q, k, v)))
    fwd_step, bwd_step = ((ring_fwd_step_reference, ring_bwd_step_reference) if plain
                          else (None, None))
    q2 = _prescale(q, scale)
    o = torch.empty_like(q)
    lses = _ring_forward(xport, xport.split(q2), xport.split(k), xport.split(v), xport.split(o),
                         causal=causal, window=window, step=fwd_step)
    if do is None:
        return o[..., :D], xport.join(lses)
    grads = _ring_grads(xport, q2, k, v, o, lses, *_pad_d(do), scale=scale, causal=causal,
                        window=window, step=bwd_step)
    return (o[..., :D], xport.join(lses), *(g[..., :D] for g in grads))
