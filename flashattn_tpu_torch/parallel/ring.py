"""Ring attention's algebra (port of flashattn_tpu/parallel/ring.py, in part).

Each rank of a ring of P holds one contiguous sequence chunk of Q and of K/V;
the K/V chunks rotate one rank to the right per step, and each partial result
merges into the running one by the LSE rule ``L = logaddexp(L1, L2); O =
e^{L1-L} O1 + e^{L2-L} O2``. This module keeps the pieces the ring kernels
(``parallel/ring_kernel.py``) share with the JAX ring: the neighbour pairs of a
rotation, the merge of two normalized partials, and the whole-chunk skip
predicate. Here rank and step are host ints, so :func:`_chunk_needed` is a
Python bool and a chunk outside the band is never launched, where JAX traces
it into ``lax.cond``. ``ring_attention`` itself (the ppermute ring on K1, K5
and K6 with offsets) is not ported yet (ROADMAP queue 1, item 1).
"""

from __future__ import annotations

import torch


def _perm(n: int) -> list[tuple[int, int]]:
    """The (source, destination) pairs of one rotation: rank i sends to i + 1."""
    return [(i, (i + 1) % n) for i in range(n)]


def _merge(o, lse, o_p, lse_p):
    """LSE-weighted merge of two normalized partials (f32): ``(O, LSE)``."""
    lse_new = torch.logaddexp(lse, lse_p)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(lse_p - lse_new)[..., None]
    return o * w_old + o_p * w_new, lse_new


def _chunk_needed(q_off: int, kv_off: int, nq: int, nk: int, causal: bool, window) -> bool:
    """Whether a KV chunk at global columns ``[kv_off, kv_off + nk)`` holds a
    pair that a Q chunk at rows ``[q_off, q_off + nq)`` attends under
    ``causal`` and ``window = (left, right)`` (conservative: the JAX
    predicate, ring.py:190-200)."""
    wl, wr = window if window is not None else (-1, -1)
    needed = True
    if causal or wr >= 0:
        bound = q_off + nq - 1 + (wr if (wr >= 0 and not causal) else 0)
        needed = kv_off <= bound
    if wl >= 0:
        needed = needed and kv_off + nk - 1 >= q_off - wl
    return bool(needed)
