"""Compare the kernels of two checkouts of the port, in turns, on one NVIDIA GPU.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--order 0,1,1,0,0,1] [--cases bias_bwd,...]

First, per checkout, one child builds its kernels from its own
``flashattn_tpu_torch/csrc/`` (into its own ``build/``) with ``ptxas -v`` and
reads the library's SASS with ``cuobjdump``; chip_ab prints each build's
instantiations and seconds, per case below each checkout's registers, stack
frame and SASS instruction count and the opcodes whose counts differ most,
and then every instantiation of both builds whose SASS instruction count
differs. Then each entry of ``--order`` (0: the first
directory, 1: the second) runs one child from that checkout, which times the
kernels at the shapes of the port's paths with chip_smoke.cuda_ms (CUDA
events, median over 7 trials of the mean of 20 launches), all of them or
those that ``--cases`` names:

* ``unet``: K1 non-causal, B1 H8 N4096 D40, BNHD (SD1.5's level-0 attention);
* ``lm``: K1 causal at chip_smoke's "lm" shape, B1 Hq16 Hkv8 N2048 D128, BNHD;
* ``k3``: K3 causal at the ``lm`` shape (the mma.sync ``fwd_tile.cuh`` K1
  and ``dkv_tile.cuh`` K3 of a parent before K1's dense route and K3's
  Hopper kernel, their TMA + wgmma kernels after);
* ``decode``, ``decode_int8``, ``decode_fp8``: K1's decode route (the
  split-KV decode kernel and its merge) with the cache-slot bias,
  q [8, 8, 2, 128] against bf16 / int8 / fp8 K/V [8, 8, 8192, 128]
  (bench_decode's folded decode attention, half live);
* ``k1_seg``, ``split_seg``: K1 with segment ids and its backward at
  bench_lm's packed cell, B2 Hq16 Hkv8 N4096 D128 causal, 8 documents per
  row: ``flash_bwd.dkv`` then ``flash_bwd.dq`` (K5 + K6, mma.sync) in a
  parent before K5 + K6's split route, ``flash_bwd.split_bwd`` (one TMA +
  wgmma kernel) after;
* ``k1_win``, ``k3_win``, ``split_cap``, ``k1_cap``: K1 and K3 with the SWA
  window, and the backward and K1 with the window and softcap 50 (K5 + K6,
  or the split route, as ``split_seg``; K1 on ``fwd_tile.cuh`` in a parent
  before K1's dense route took the cap, on the dense route after), at B1
  Hq16 Hkv8 N8192 D128;
* ``k1_bias``: K1 with path A's key-padding bias [4, 1, N, N] at B4 H16
  N2048 D128, BNHD (the dense K1 before K1's bias route, the TMA + wgmma
  bias kernel after);
* ``bias_bwd``, ``bias_bwd_dbias``, ``bias_bwd_cap``, ``bias_bwd_d96``: the
  backward of path A's mask arm (that bias, no dbias), of its learned arm
  (the [4, 16, N, N] bias with dbias), of the learned arm with softcap 50
  (dbias) and of the mask arm at D 96, at the same shape:
  ``flash_bwd.dkv`` then ``flash_bwd.dq`` (K5 + K6, mma.sync) in a parent
  whose ``flash_bwd.bias_bwd`` (one TMA + wgmma kernel) does not take the
  call, ``bias_bwd`` where it does;
* ``k1_bias_d256``, ``k1_bias_d256_learned``: K1 with path A's key-padding
  bias and with it plus a normal [1, 8, N, N] bias at heads of 256 (B4 H8
  N2048 D256, BNHD): ``fwd_tile.cuh`` in a parent before K1's bias route
  took D 256, its D 256 form after;
* ``quant_int8``, ``quant_fp8``, ``quant_swa_int8``: the quantized prefill,
  ``flash_attention_quantized(causal=True)`` at chip_smoke's
  QUANT_PREFILL_SHAPE (B1 Hq16 Hkv8 N2048 D128) on int8 / fp8 K/V
  (``fwd_tile.cuh``'s mma.sync K1 in a parent before K1's quantized route,
  that route after), and int8 K/V with SWA's window at B1 Hq16 Hkv8 N8192
  D128 through ``flash_fwd.fwd`` (a parent before the quantized route
  refuses it: timed in the second tree only);
* ``gemm``: K9 at 4096^3, bf16 out;
* ``ring_fwd``, ``ring_bwd``: K7 and K8 on one full off-diagonal chunk pair
  of the ring's main shape (rank 1's 4096 query rows against rank 0's K/V,
  B1 Hq16 Hkv8 D128 causal; the mma.sync kernels of a parent whose
  ``csrc/ring.cu`` had them, the TMA + wgmma kernels after).
* ``k1_d256``, ``ring_fwd_d256``: K1's dense body at D 256, as its dense
  route at the LM's attention with heads of 256 (B1 Hq8 Hkv4 N2048 D256
  causal, the raw launch ``flash_fwd._launch_dense_sm90``) and as K7's D 256
  form on one full off-diagonal 4096 x 4096 chunk pair at Hq8 Hkv4 D256
  (``ring_kernel.ring_fwd_step``, a middle step: the state read, merged and
  written).
* ``f32_k3``: K3 on f32 (the f32 backward body ``flash_bwd_f32.cu``) at the
  ``lm`` shape, TF32 off;
* ``f32_bias_bwd``, ``f32_bias_bwd_dbias``, ``f32_bias_bwd_d256``,
  ``f32_bias_bwd_d256_dbias``: the same body's BIAS family at f32 path A's
  attention, B4 H16 N2048 D128 and B4 H8 N2048 D256, f32, TF32 off, the
  key-padding bias [4, 1, N, N] without dbias and it plus a normal [1, H,
  N, N] with dbias, through ``flash_bwd.bias_bwd``.

The children take their helpers and shapes from this checkout's
chip_smoke.py, and pass only arguments that both checkouts take. Prints the
card's name and power limit, one line per child, then per case each
checkout's times, their medians and the second's median over the first's.
K5's instantiations lost K3's dQ template argument with K3's Hopper kernel
(``dkv_kernel<128, 0>`` became ``dkv_kernel<128>``), and the Hopper K1
routes and the bias route's backward gained the softcap's (``fwd_dense_sm90_
kernel<128, 0>`` became ``<128, 0, 0>``, ``fwd_bias_sm90_kernel<128>``
``<128, 0>``, ``bwd_bias_sm90_kernel<128, 1>`` ``<128, 1, 0>``), then the
bias routes segment ids' (``fwd_bias_sm90_kernel<128, 0>`` became ``<128, 0,
0>`` with SEG second, ``bwd_bias_sm90_kernel<128, 1, 0>`` ``<128, 1, 0, 0>``
with SEG last); the SASS report names a parent's by the later name, so that
they count as the same instantiation.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import chip_smoke

SMOKE = pathlib.Path(__file__).resolve().with_name("chip_smoke.py")
# The instantiation each case launches (chip_smoke.instantiation_name), or
# (the first tree's, the second's) where a redesigned route launches another
# kernel than a parent before it; " + " joins the kernels one case launches.
CASE_KERNELS = {"unet": "K1 dense sm90 fwd_dense_sm90_kernel<64, 0, 0>",
                "lm": "K1 dense sm90 fwd_dense_sm90_kernel<128, 0, 0>",
                "k3": "K3 sm90 bwd_sm90_kernel<128>",
                "decode": "K1 decode bias decode_kernel<128, 0, 1, 0>",
                "decode_int8": "K1 decode int8 bias decode_kernel<128, 1, 1, 0>",
                "decode_fp8": "K1 decode fp8 bias decode_kernel<128, 2, 1, 0>",
                "k1_seg": "K1 dense sm90 segments fwd_dense_sm90_kernel<128, 1, 0>",
                "split_seg": "K5 + K6 split sm90 segments bwd_split_sm90_kernel<128, 1, 0>",
                "k1_win": "K1 dense sm90 fwd_dense_sm90_kernel<128, 0, 0>",
                "k3_win": "K3 sm90 bwd_sm90_kernel<128>",
                "split_cap": "K5 + K6 split sm90 softcap bwd_split_sm90_kernel<128, 0, 1>",
                "k1_cap": ("K1 softcap window fwd_window_kernel<128, 0, 1>",
                           "K1 dense sm90 softcap fwd_dense_sm90_kernel<128, 0, 1>"),
                "k1_bias": "K1 bias sm90 fwd_bias_sm90_kernel<128, 0, 0>",
                "bias_bwd": "bias bwd sm90 bwd_bias_sm90_kernel<128, 0, 0, 0>",
                "bias_bwd_dbias": "bias bwd sm90 bwd_bias_sm90_kernel<128, 1, 0, 0>",
                "bias_bwd_cap": ("K5 softcap bias dkv_bias_kernel<128, 1> + K6 softcap bias "
                                 "dq_bias_kernel<128, 1>",
                                 "bias bwd sm90 softcap bwd_bias_sm90_kernel<128, 1, 1, 0>"),
                "bias_bwd_d96": ("K5 bias dkv_bias_kernel<96, 0> + K6 bias dq_bias_kernel<96, 0>",
                                 "bias bwd sm90 bwd_bias_sm90_kernel<128, 0, 0, 0>"),
                "k1_bias_d256": ("K1 bias fwd_kernel<256, 1, 0>",
                                 "K1 bias sm90 fwd_bias_sm90_kernel<256, 0, 0>"),
                "k1_bias_d256_learned": ("K1 bias fwd_kernel<256, 1, 0>",
                                         "K1 bias sm90 fwd_bias_sm90_kernel<256, 0, 0>"),
                "quant_int8": ("K1 int8 fwd_kernel<128, 0, 1>",
                               "K1 quant sm90 int8 fwd_quant_sm90_kernel<128, 1, 0, 0>"),
                "quant_fp8": ("K1 fp8 fwd_kernel<128, 0, 2>",
                              "K1 quant sm90 fp8 fwd_quant_sm90_kernel<128, 2, 0, 0>"),
                "quant_swa_int8": "K1 quant sm90 int8 fwd_quant_sm90_kernel<128, 1, 0, 0>",
                "gemm": "K9 gemm_wgmma_kernel<0>",
                "ring_fwd": "K7 ring_fwd_sm90_kernel<128>",
                "ring_bwd": "K8 ring_bwd_sm90_kernel<128>",
                "k1_d256": "K1 dense sm90 fwd_dense_sm90_kernel<256, 0, 0>",
                "ring_fwd_d256": "K7 d256 ring_fwd_wide_kernel",
                "f32_k3": "bwd f32 bwd_f32_kernel<128, 0, 0, 0>",
                "f32_bias_bwd": "bwd f32 bias bwd_f32_kernel<128, 0, 0, 1>",
                "f32_bias_bwd_dbias": "bwd f32 bias bwd_f32_kernel<128, 0, 0, 1>",
                "f32_bias_bwd_d256": "bwd f32 bias bwd_f32_kernel<256, 0, 0, 1>",
                "f32_bias_bwd_d256_dbias": "bwd f32 bias bwd_f32_kernel<256, 0, 0, 1>"}

LOAD_SMOKE = r'''
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
'''

CODE = LOAD_SMOKE + r'''
from flashattn_tpu_torch.utils import native
lib, out = native.build(("-Xptxas", "-v"))
print("CODE " + json.dumps({"lib": str(lib), "ptxas": cs.ptxas_stats(out)}), flush=True)
'''

TIME = LOAD_SMOKE + r'''
import inspect
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd, gemm, quant
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import make_qkv

CASES = json.loads(sys.argv[2])  # the cases to time; empty: all

def timed(name, fn):
    if not CASES or name in CASES:
        out[name] = cs.cuda_ms(fn, trials=7)

native.kernels()
out = {}
split = getattr(flash_bwd, "split_bwd", None)  # none in a parent before K5 + K6's split route

def split_bwd(*args, **kw):
    if split is not None:
        return split(*args, **kw)
    return flash_bwd.dkv(*args, **kw), flash_bwd.dq(*args, **kw)

q, k, v = (cs._bnhd(x) for x in make_qkv(1, 1, 8, 4096, 40, dtype=torch.bfloat16, device="cuda"))
timed("unet", lambda: flash_fwd.fwd(q, k, v, scale=40 ** -0.5))
_, B, Hq, Hkv, N, _, D = cs.CAUSAL_CASES[0]
q, k, v = (cs._bnhd(x) for x in make_qkv(2, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                         device="cuda"))
kw = dict(scale=D ** -0.5, causal=True)
timed("lm", lambda: flash_fwd.fwd(q, k, v, **kw))
do = cs._bnhd(make_qkv(3, B, Hq, N, D, dtype=torch.bfloat16, device="cuda")[0])
o, lse = flash_fwd.fwd(q, k, v, **kw)
delta = (do.float() * o.float()).sum(-1)
timed("k3", lambda: flash_bwd_fused.bwd(q, k, v, do, lse, delta, **kw))
q, k, v = make_qkv(4, cs.DECODE_B, 8, 2, cs.DECODE_D, Nk=cs.DECODE_NK, dtype=torch.bfloat16,
                   device="cuda")
bias = cs._decode_slot_bias(cs.DECODE_NK, cs.DECODE_NK // 2)
timed("decode", lambda: flash_fwd.fwd(q, k, v, scale=cs.DECODE_D ** -0.5, bias=bias))
for name, dtype in (("decode_int8", torch.int8), ("decode_fp8", torch.float8_e4m3fn)):
    qkv = quant.quantize_kv(k, v, dtype, allow_slow_fp8=True)
    timed(name, lambda: flash_fwd.fwd(q, qkv.k_q, qkv.v_q, scale=cs.DECODE_D ** -0.5,
                                         bias=bias, k_scale=qkv.k_scale, v_scale=qkv.v_scale))
_, B, Hq, Hkv, N, _, D = cs.SEG_CASES[0][:7]
q, k, v = (cs._bnhd(x) for x in make_qkv(5, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                         device="cuda"))
do = cs._bnhd(make_qkv(6, B, Hq, N, D, dtype=torch.bfloat16, device="cuda")[0])
ids = cs.packed_ids(B, N + 1)[:, :N]
kw = dict(scale=D ** -0.5, causal=True, segment_ids=(ids, ids))
o, lse = flash_fwd.fwd(q, k, v, **kw)
delta = (do.float() * o.float()).sum(-1)
timed("k1_seg", lambda: flash_fwd.fwd(q, k, v, **kw))
timed("split_seg", lambda: split_bwd(q, k, v, do, lse, delta, **kw))
_, B, Hq, Hkv, N, _, D, causal, window = cs.WINDOW_CASES[0]
q, k, v = (cs._bnhd(x) for x in make_qkv(7, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                         device="cuda"))
do = cs._bnhd(make_qkv(8, B, Hq, N, D, dtype=torch.bfloat16, device="cuda")[0])
for name, kw in (("k3_win", dict(scale=D ** -0.5, causal=causal, window=window)),
                 ("split_cap", dict(scale=D ** -0.5, causal=causal, window=window,
                                    softcap=cs.SOFTCAP))):
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    if name == "k3_win":
        timed("k1_win", lambda: flash_fwd.fwd(q, k, v, **kw))
        timed(name, lambda: flash_bwd_fused.bwd(q, k, v, do, lse, delta, **kw))
    else:
        timed(name, lambda: split_bwd(q, k, v, do, lse, delta, **kw))
        timed("k1_cap", lambda: flash_fwd.fwd(q, k, v, **kw))
B, N = len(cs.ATTN_LENGTHS), cs.ATTN_SEQ
q, k, v = (cs._bnhd(x) for x in make_qkv(10, B, 16, N, 128, dtype=torch.bfloat16,
                                         device="cuda"))
pad = cs._padding_bias(cs.ATTN_LENGTHS, N)
timed("k1_bias", lambda: flash_fwd.fwd(q, k, v, scale=128 ** -0.5, bias=pad))
do = cs._bnhd(make_qkv(13, B, 16, N, 128, dtype=torch.bfloat16, device="cuda")[0])
learned = pad + torch.randn((1, 16, N, N), generator=torch.Generator(device="cuda").manual_seed(14),
                            device="cuda")
# A bias route backward without the softcap argument takes neither the cap
# nor D 96: K5 + K6 (mma.sync) take those calls in such a tree.
route = getattr(flash_bwd, "bias_bwd", None)
wide = route is not None and "softcap" in inspect.signature(route).parameters
q96, k96, v96 = (cs._bnhd(x) for x in make_qkv(15, B, 16, N, 96, dtype=torch.bfloat16,
                                               device="cuda"))
do96 = cs._bnhd(make_qkv(16, B, 16, N, 96, dtype=torch.bfloat16, device="cuda")[0])
for name, bias, want_dbias, cap, d in (("bias_bwd", pad, False, None, 128),
                                       ("bias_bwd_dbias", learned, True, None, 128),
                                       ("bias_bwd_cap", learned, True, cs.SOFTCAP, 128),
                                       ("bias_bwd_d96", pad, False, None, 96)):
    kw = dict(scale=d ** -0.5, bias=bias, **({} if cap is None else {"softcap": cap}))
    qkv = (q, k, v, do) if d == 128 else (q96, k96, v96, do96)
    o, lse = flash_fwd.fwd(*qkv[:3], **kw)
    args = (*qkv, lse, (qkv[3].float() * o.float()).sum(-1))
    if route is None or ((cap is not None or d != 128) and not wide):
        timed(name, lambda: (flash_bwd.dkv(*args, **kw),
                                flash_bwd.dq(*args, want_dbias=want_dbias, **kw)))
    else:
        timed(name, lambda: route(*args, want_dbias=want_dbias, **kw))
del q, k, v, do, q96, k96, v96, do96, learned, o, lse, args
torch.cuda.empty_cache()
# K1 with path A's biases at heads of 256 (B4 H8 N2048 D256): fwd_tile.cuh in
# a parent before the bias route's D 256 form.
q, k, v = (cs._bnhd(x) for x in make_qkv(17, B, 8, N, 256, dtype=torch.bfloat16, device="cuda"))
learned = pad + torch.randn((1, 8, N, N), generator=torch.Generator(device="cuda").manual_seed(18),
                            device="cuda")
timed("k1_bias_d256", lambda: flash_fwd.fwd(q, k, v, scale=256 ** -0.5, bias=pad))
timed("k1_bias_d256_learned", lambda: flash_fwd.fwd(q, k, v, scale=256 ** -0.5, bias=learned))
del q, k, v, pad, learned
torch.cuda.empty_cache()
B, Hq, Hkv, N, D = cs.QUANT_PREFILL_SHAPE
q, k, v = make_qkv(19, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16, device="cuda")
for name, dt in (("quant_int8", torch.int8), ("quant_fp8", torch.float8_e4m3fn)):
    qkv = quant.quantize_kv(k, v, dt, allow_slow_fp8=True)
    timed(name, lambda: quant.flash_attention_quantized(q, qkv, causal=True))
_, B, Hq, Hkv, N, _, D, causal, window = cs.WINDOW_CASES[0]
q, k, v = make_qkv(20, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16, device="cuda")
qkv = quant.quantize_kv(k, v, torch.int8)
kw = dict(scale=D ** -0.5, causal=causal, window=window, k_scale=qkv.k_scale,
          v_scale=qkv.v_scale)
try:  # a parent before K1's quantized route refuses a window on quantized K/V
    flash_fwd.fwd(q, qkv.k_q, qkv.v_q, **kw)
    timed("quant_swa_int8", lambda: flash_fwd.fwd(q, qkv.k_q, qkv.v_q, **kw))
except NotImplementedError:
    pass
del q, k, v, qkv
torch.cuda.empty_cache()
a, b = (x[0, 0].contiguous() for x in make_qkv(9, 1, 1, 4096, 4096, dtype=torch.bfloat16,
                                                device="cuda")[:2])
timed("gemm", lambda: gemm.matmul(a, b))
del a, b
from flashattn_tpu_torch.parallel import ring_kernel as rk
c, hq, hkv = cs.RING_CHUNK, 16, 8
q, k, v = make_qkv(11, 1, hq, 2 * c, 128, Hkv=hkv, dtype=torch.bfloat16, device="cuda")
do = make_qkv(12, 1, hq, 2 * c, 128, dtype=torch.bfloat16, device="cuda")[0]
o, lse = rk.run_virtual_ring(q, k, v, ranks=2, causal=True)
q2 = rk._prescale(q, 128 ** -0.5)
lse1, delta1 = lse[:, :, c:].contiguous(), (do.float() * o.float()).sum(-1)[:, :, c:].contiguous()
f32 = dict(dtype=torch.float32, device="cuda")
acc, m, l = (torch.zeros((1, hq, c, 128), **f32), torch.zeros((1, hq, c), **f32),
             torch.ones((1, hq, c), **f32))
o1, lse_c = torch.empty_like(q2[:, :, c:]), torch.empty((1, hq, c), **f32)
dq, dk, dv = (torch.zeros((1, h, c, 128), **f32) for h in (hq, hkv, hkv))
pos = dict(q_base=c, kv_off=0, causal=True)
timed("ring_fwd", lambda: rk.ring_fwd_step(q2[:, :, c:], k[:, :, :c], v[:, :, :c], acc, m, l,
                                             o1, lse_c, **pos))
timed("ring_bwd", lambda: rk.ring_bwd_step(q2[:, :, c:], k[:, :, :c], v[:, :, :c],
                                             do[:, :, c:], lse1, delta1, dq, dk, dv, **pos))
del q, k, v, do, o, lse, q2, acc, m, l, o1, lse_c, dq, dk, dv
torch.cuda.empty_cache()
# K1's dense body at D 256: its dense route at the LM's attention with heads
# of 256, and K7's D 256 form on the ring's off-diagonal chunk pair at Hq8 Hkv4.
B, Hq, Hkv, N, D = cs.WIDE_SHAPE
q, k, v = (cs._bnhd(x) for x in make_qkv(28, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                         device="cuda"))
o, lse = torch.empty_like(q), torch.empty((B, Hq, N), dtype=torch.float32, device="cuda")
stream = torch.cuda.current_stream().cuda_stream
timed("k1_d256", lambda: flash_fwd._launch_dense_sm90(
    native.kernels(), q, k, v, o, lse, None, scale=D ** -0.5, kv_valid_len=N, causal=True,
    window=None, softcap=None, stream=stream))
hq, hkv = 8, 4
q, k, v = make_qkv(29, 1, hq, 2 * c, D, Hkv=hkv, dtype=torch.bfloat16, device="cuda")
q2 = rk._prescale(q, D ** -0.5)
acc, m, l = (torch.zeros((1, hq, c, D), **f32), torch.zeros((1, hq, c), **f32),
             torch.ones((1, hq, c), **f32))
o1, lse_c = torch.empty_like(q2[:, :, c:]), torch.empty((1, hq, c), **f32)
timed("ring_fwd_d256", lambda: rk.ring_fwd_step(q2[:, :, c:], k[:, :, :c], v[:, :, :c], acc, m,
                                                  l, o1, lse_c, **pos))
del q, k, v, o, lse, q2, acc, m, l, o1, lse_c
torch.cuda.empty_cache()
# The f32 backward body (flash_bwd_f32.cu), TF32 off: K3 on f32 at the f32
# LM's attention, and its BIAS family at f32 path A's attention, heads of 128
# and of 256, the mask arm without dbias and the learned arm with it.
cs._f32_tf32_off()
_, B, Hq, Hkv, N, _, D = cs.CAUSAL_CASES[0]
q, k, v = (cs._bnhd(x) for x in make_qkv(23, B, Hq, N, D, Hkv=Hkv, device="cuda"))
do = cs._bnhd(make_qkv(24, B, Hq, N, D, device="cuda")[0])
kw = dict(scale=D ** -0.5, causal=True)
o, lse = flash_fwd.fwd(q, k, v, **kw)
delta = (do * o).sum(-1)
timed("f32_k3", lambda: flash_bwd_fused.bwd(q, k, v, do, lse, delta, **kw))
B, N = len(cs.ATTN_LENGTHS), cs.ATTN_SEQ
pad = cs._padding_bias(cs.ATTN_LENGTHS, N)
for h, d in ((cs.ATTN_WIDTH["num_heads"], 128), (cs.WIDE_ATTN_WIDTH["num_heads"], 256)):
    q, k, v = make_qkv(25, B, h, N, d, device="cuda")
    do = make_qkv(26, B, h, N, d, device="cuda")[0]
    learned = pad + torch.randn((1, h, N, N), device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(27))
    sfx = "" if d == 128 else "_d256"
    for name, bias, want_dbias in ((f"f32_bias_bwd{sfx}", pad, False),
                                   (f"f32_bias_bwd{sfx}_dbias", learned, True)):
        kw = dict(scale=d ** -0.5, bias=bias)
        o, lse = flash_fwd.fwd(q, k, v, **kw)
        args = (q, k, v, do, lse, (do * o).sum(-1))
        timed(name, lambda: flash_bwd.bias_bwd(*args, want_dbias=want_dbias, **kw))
    del q, k, v, do, learned, o, lse, args
    torch.cuda.empty_cache()
print("AB " + json.dumps(out), flush=True)
'''


def _canonical(name: str) -> str:
    """A parent's instantiation under its later name: K5's without K3's dQ
    argument (0 for K5), the Hopper K1 routes' and the bias route
    backward's with the softcap's (0), the bias routes' with segment ids'
    (0); every other name as it is."""
    name = re.sub(r"^(K5[^<]* dkv(?:_window)?_kernel<\d+), 0([,>])", r"\1\2", name)
    name = re.sub(r"^(bias bwd sm90(?! d256)[^<]*<\d+, \d+)>$", r"\1, 0>", name)
    name = re.sub(r"^(bias bwd sm90(?! d256)[^<]*<\d+, \d+, \d+)>$", r"\1, 0>", name)
    name = re.sub(r"^(K1 bias sm90[^<]*<\d+)>$", r"\1, 0>", name)
    name = re.sub(r"^(K1 bias sm90[^<]*<\d+), (\d+)>$", r"\1, 0, \2>", name)
    return re.sub(r"^(K1 dense sm90[^<]*<\d+, \d+)>$", r"\1, 0>", name)


def child(tree: pathlib.Path, code: str, tag: str, cases: list = ()) -> dict:
    """Run ``code`` in ``tree`` (its package first on the path; ``cases`` its
    second argument) and return the JSON of its output line that starts with
    ``tag``."""
    proc = subprocess.run([sys.executable, "-c", code, str(SMOKE), json.dumps(list(cases))],
                          cwd=tree, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(tree)})
    line = [x for x in proc.stdout.splitlines() if x.startswith(tag + " ")]
    if proc.returncode != 0 or not line:
        raise SystemExit(f"chip_ab: the child in {tree} failed ({proc.returncode}):\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(line[0][len(tag) + 1:])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, type=pathlib.Path, help="two checkouts of the repo")
    ap.add_argument("--order", default="0,1,1,0,0,1",
                    help="comma-separated indices into the trees, one child each")
    ap.add_argument("--cases", default="",
                    help=f"comma-separated cases to time (default all): {', '.join(CASE_KERNELS)}")
    args = ap.parse_args()
    cases = [c for c in args.cases.split(",") if c]
    if set(cases) - set(CASE_KERNELS):
        ap.error(f"unknown cases {sorted(set(cases) - set(CASE_KERNELS))}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = [t.resolve() for t in args.trees]

    code = []
    for t, shown in zip(trees, args.trees):
        t0 = time.perf_counter()
        code.append(child(t, CODE, "CODE"))
        print(f"[code] {shown}: {len(code[-1]['ptxas'])} instantiations built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    ops = [{_canonical(n): c for n, c in chip_smoke.sass_opcodes(x["lib"], set(x["ptxas"])).items()}
           for x in code]
    for x in code:
        x["ptxas"] = {_canonical(n): v for n, v in x["ptxas"].items()}
    for case, name in CASE_KERNELS.items():
        names = (name, name) if isinstance(name, str) else name
        cols = []
        for t, c, o, nm in zip(args.trees, code, ops, names):
            stats = [c["ptxas"].get(x, (None, None))[:2] for x in nm.split(" + ")]
            cols.append(f"{t} {nm}: {' + '.join(str(r) for r, _ in stats)} registers, "
                        f"{' + '.join(str(st) for _, st in stats)} B stack, "
                        f"{sum(sum(o.get(x, {}).values()) for x in nm.split(' + '))} SASS "
                        "instructions")
        a, b = (sum((o.get(x, collections.Counter()) for x in nm.split(" + ")),
                    collections.Counter()) for o, nm in zip(ops, names))
        diff = sorted(set(a) | set(b), key=lambda x: -abs(b[x] - a[x]))[:8]
        print(f"[code] {case}: {'; '.join(cols)}; opcodes that differ most "
              f"(first -> second): " + ", ".join(f"{x} {a[x]} -> {b[x]}" for x in diff), flush=True)
    shared = sorted(set(ops[0]) & set(ops[1]))
    changed = [n for n in shared if sum(ops[0][n].values()) != sum(ops[1][n].values())]
    print(f"[code] instantiations in both: {len(shared)}, with another SASS instruction count: "
          f"{len(changed)}" + "".join(f"; {n} {sum(ops[0][n].values())} -> "
                                      f"{sum(ops[1][n].values())}" for n in changed)
          + f"; only in {args.trees[1]}: {sorted(set(ops[1]) - set(ops[0]))}", flush=True)

    runs = {0: [], 1: []}
    for i in (int(x) for x in args.order.split(",")):
        res = child(trees[i], TIME, "AB", cases)
        runs[i].append(res)
        print(f"[ab] {args.trees[i]}: " + ", ".join(f"{k} {v:.5f} ms" for k, v in res.items()),
              flush=True)
    for case in dict.fromkeys([*runs[0][0], *runs[1][0]]):
        a = [r[case] for r in runs[0] if case in r]
        b = [r[case] for r in runs[1] if case in r]
        if not a or not b:
            tree, times = (args.trees[0], a) if a else (args.trees[1], b)
            print(f"[ab] {case}: {tree} only, {' / '.join(f'{x:.5f}' for x in times)} ms, "
                  f"median {statistics.median(times):.5f} ms", flush=True)
            continue
        print(f"[ab] {case}: {args.trees[0]} {' / '.join(f'{x:.5f}' for x in a)} ms, "
              f"{args.trees[1]} {' / '.join(f'{x:.5f}' for x in b)} ms; medians "
              f"{statistics.median(a):.5f} vs {statistics.median(b):.5f} ms, "
              f"{statistics.median(b) / statistics.median(a) - 1:+.2%}", flush=True)


if __name__ == "__main__":
    main()
