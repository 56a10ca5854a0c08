"""Compare the kernels of two checkouts of the port, in turns, on one NVIDIA GPU.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--order 0,1,1,0,0,1]

First, per checkout, one child builds its kernels from its own
``flashattn_tpu_torch/csrc/`` (into its own ``build/``) with ``ptxas -v`` and
reads the library's SASS with ``cuobjdump``; chip_ab prints, per case below,
each checkout's registers, stack frame and SASS instruction count, and the
opcodes whose counts differ most. Then each entry of ``--order`` (0: the first
directory, 1: the second) runs one child from that checkout, which times the
kernels at the shapes of the port's paths with chip_smoke.cuda_ms (CUDA
events, median over 7 trials of the mean of 20 launches):

* ``unet``: K1 non-causal, B1 H8 N4096 D40, BNHD (SD1.5's level-0 attention);
* ``lm``: K1 causal at chip_smoke's "lm" shape, B1 Hq16 Hkv8 N2048 D128, BNHD;
* ``k3``: K3 causal at the ``lm`` shape;
* ``decode``: K1 with the cache-slot bias, q [8, 8, 2, 128] against K/V
  [8, 8, 8192, 128] (bench_decode's folded decode attention, half live);
* ``k1_seg``, ``k5``, ``k6``: K1 with segment ids, K5 and K6 at bench_lm's
  packed cell, B2 Hq16 Hkv8 N4096 D128 causal, 8 documents per row;
* ``k3_win``, ``k5_cap``, ``k6_cap``: K3 with the SWA window, and K5 / K6
  with the window and softcap 50, at B1 Hq16 Hkv8 N8192 D128.

The children take their helpers and shapes from this checkout's
chip_smoke.py, and pass only arguments that both checkouts take. Prints the
card's name and power limit, one line per child, then per case each
checkout's times, their medians and the second's median over the first's.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import statistics
import subprocess
import sys

import chip_smoke

SMOKE = pathlib.Path(__file__).resolve().with_name("chip_smoke.py")
# The instantiation each case launches (chip_smoke.instantiation_name).
CASE_KERNELS = {"unet": "K1 fwd_kernel<48, 0, 0, 0>", "lm": "K1 fwd_kernel<128, 0, 0, 0>",
                "k3": "K3 dkv_kernel<128, 1>", "decode": "K1 bias fwd_kernel<128, 0, 1, 0>",
                "k1_seg": "K1 segments fwd_kernel<128, 1, 0, 0>", "k5": "K5 dkv_kernel<128, 0>",
                "k6": "K6 dq_kernel<128>", "k3_win": "K3 window dkv_window_kernel<128, 1, 0>",
                "k5_cap": "K5 softcap window dkv_window_kernel<128, 0, 1>",
                "k6_cap": "K6 softcap window dq_window_kernel<128, 1>"}

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
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import make_qkv

def ms(fn):
    return cs.cuda_ms(fn, trials=7)

native.kernels()
out = {}
q, k, v = (cs._bnhd(x) for x in make_qkv(1, 1, 8, 4096, 40, dtype=torch.bfloat16, device="cuda"))
out["unet"] = ms(lambda: flash_fwd.fwd(q, k, v, scale=40 ** -0.5))
_, B, Hq, Hkv, N, _, D = cs.CAUSAL_CASES[0]
q, k, v = (cs._bnhd(x) for x in make_qkv(2, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                         device="cuda"))
kw = dict(scale=D ** -0.5, causal=True)
out["lm"] = ms(lambda: flash_fwd.fwd(q, k, v, **kw))
do = cs._bnhd(make_qkv(3, B, Hq, N, D, dtype=torch.bfloat16, device="cuda")[0])
o, lse = flash_fwd.fwd(q, k, v, **kw)
delta = (do.float() * o.float()).sum(-1)
out["k3"] = ms(lambda: flash_bwd_fused.bwd(q, k, v, do, lse, delta, **kw))
q, k, v = make_qkv(4, cs.DECODE_B, 8, 2, cs.DECODE_D, Nk=cs.DECODE_NK, dtype=torch.bfloat16,
                   device="cuda")
bias = cs._decode_slot_bias(cs.DECODE_NK, cs.DECODE_NK // 2)
out["decode"] = ms(lambda: flash_fwd.fwd(q, k, v, scale=cs.DECODE_D ** -0.5, bias=bias))
_, B, Hq, Hkv, N, _, D = cs.SEG_CASES[0][:7]
q, k, v = (cs._bnhd(x) for x in make_qkv(5, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                         device="cuda"))
do = cs._bnhd(make_qkv(6, B, Hq, N, D, dtype=torch.bfloat16, device="cuda")[0])
ids = cs.packed_ids(B, N + 1)[:, :N]
kw = dict(scale=D ** -0.5, causal=True, segment_ids=(ids, ids))
o, lse = flash_fwd.fwd(q, k, v, **kw)
delta = (do.float() * o.float()).sum(-1)
out["k1_seg"] = ms(lambda: flash_fwd.fwd(q, k, v, **kw))
out["k5"] = ms(lambda: flash_bwd.dkv(q, k, v, do, lse, delta, **kw))
out["k6"] = ms(lambda: flash_bwd.dq(q, k, v, do, lse, delta, **kw))
_, B, Hq, Hkv, N, _, D, causal, window = cs.WINDOW_CASES[0]
q, k, v = (cs._bnhd(x) for x in make_qkv(7, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                         device="cuda"))
do = cs._bnhd(make_qkv(8, B, Hq, N, D, dtype=torch.bfloat16, device="cuda")[0])
for name, kw in (("k3_win", dict(scale=D ** -0.5, causal=causal, window=window)),
                 ("k5_cap", dict(scale=D ** -0.5, causal=causal, window=window,
                                 softcap=cs.SOFTCAP))):
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    if name == "k3_win":
        out[name] = ms(lambda: flash_bwd_fused.bwd(q, k, v, do, lse, delta, **kw))
    else:
        out["k5_cap"] = ms(lambda: flash_bwd.dkv(q, k, v, do, lse, delta, **kw))
        out["k6_cap"] = ms(lambda: flash_bwd.dq(q, k, v, do, lse, delta, **kw))
print("AB " + json.dumps(out), flush=True)
'''


def child(tree: pathlib.Path, code: str, tag: str) -> dict:
    """Run ``code`` in ``tree`` (its package first on the path) and return the
    JSON of its output line that starts with ``tag``."""
    proc = subprocess.run([sys.executable, "-c", code, str(SMOKE)], cwd=tree, capture_output=True,
                          text=True, env={**os.environ, "PYTHONPATH": str(tree)})
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
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = [t.resolve() for t in args.trees]

    code = [child(t, CODE, "CODE") for t in trees]
    ops = [chip_smoke.sass_opcodes(c["lib"], set(CASE_KERNELS.values())) for c in code]
    for case, name in CASE_KERNELS.items():
        cols = []
        for t, c, o in zip(args.trees, code, ops):
            regs, stack = c["ptxas"].get(name, (None, None))[:2]
            cols.append(f"{t} {regs} registers, {stack} B stack, "
                        f"{sum(o.get(name, {}).values())} SASS instructions")
        a, b = (o.get(name, collections.Counter()) for o in ops)
        diff = sorted(set(a) | set(b), key=lambda x: -abs(b[x] - a[x]))[:8]
        print(f"[code] {case} ({name}): {'; '.join(cols)}; opcodes that differ most "
              f"(first -> second): " + ", ".join(f"{x} {a[x]} -> {b[x]}" for x in diff), flush=True)

    runs = {0: [], 1: []}
    for i in (int(x) for x in args.order.split(",")):
        res = child(trees[i], TIME, "AB")
        runs[i].append(res)
        print(f"[ab] {args.trees[i]}: " + ", ".join(f"{k} {v:.5f} ms" for k, v in res.items()),
              flush=True)
    for case in runs[0][0]:
        a = [r[case] for r in runs[0]]
        b = [r[case] for r in runs[1]]
        print(f"[ab] {case}: {args.trees[0]} {' / '.join(f'{x:.5f}' for x in a)} ms, "
              f"{args.trees[1]} {' / '.join(f'{x:.5f}' for x in b)} ms; medians "
              f"{statistics.median(a):.5f} vs {statistics.median(b):.5f} ms, "
              f"{statistics.median(b) / statistics.median(a) - 1:+.2%}", flush=True)


if __name__ == "__main__":
    main()
