"""The composition fuzz's CPU arm: the port's ``flash_attention`` against the
JAX package's exact oracle on jointly drawn options.

Each seed draws one case with ``flashattn_tpu_torch.utils.testing.
sample_composition`` (the JAX fuzz's axes -- B, GQA, causal, a window,
segment ids, a bias of every broadcast shape, the softcap, f32 or bf16, the
layout, ragged Nq / Nk, q / kv offsets -- and the port's own: offsets with
segment ids, causal with Nq != Nk, D 136-256 in bf16, Nq down to 1) and its
inputs with ``composition_inputs``; the same numpy arrays go through the
port (its plain versions on the CPU) and through the JAX
``attention_reference``, forward and ``jax.vjp`` (dQ, dK, dV and, with a
bias, dbias reduced to the bias's shape). Budgets: ``FWD_TOL`` / ``BWD_TOL``
of the draw's dtype, a bf16 draw's inputs rounded to bf16 for both. The
first ``TIER1_SEEDS`` seeds run by default (the oracle compiles per shape,
~4 s a case); the rest are marked slow. ``chip_smoke.phase_fuzz`` runs the
same sampler through the kernels on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu_torch
from flashattn_tpu.ops.oracle import attention_reference
from flashattn_tpu_torch.utils.testing import (
    BWD_TOL, FWD_TOL, assert_close, composition_inputs, sample_composition)

SEED0 = 2000
TIER1_SEEDS = 12
ALL_SEEDS = 300


def _desc(c):
    return {k: (tuple(x.shape for x in v) if k == "seg" and v is not None else v)
            for k, v in c.items()}


@pytest.mark.parametrize("seed", [s if s < TIER1_SEEDS else pytest.param(s, marks=pytest.mark.slow)
                                  for s in range(ALL_SEEDS)])
def test_fuzz_composition_matches_the_jax_oracle(seed):
    c = sample_composition(np.random.default_rng(SEED0 + seed))
    x = composition_inputs(c, seed)
    desc = str(_desc(c))
    kw = dict(causal=c["causal"], window=c["window"], logit_softcap=c["softcap"],
              q_offset=c["q_off"], kv_offset=c["kv_off"])
    bnhd = c["layout"] == "BNHD"

    def lay(t):
        return t.transpose(1, 2) if bnhd else t

    leaves = [torch.from_numpy(x[n]).to(c["dtype"]).requires_grad_(True) for n in "qkv"]
    if x["bias"] is not None:
        leaves.append(torch.from_numpy(x["bias"]).requires_grad_(True))
    seg = None if c["seg"] is None else tuple(torch.from_numpy(s) for s in c["seg"])
    o = lay(flashattn_tpu_torch.flash_attention(
        *(lay(t) for t in leaves[:3]), bias=leaves[3] if len(leaves) == 4 else None,
        segment_ids=seg, layout=c["layout"], **kw))
    do = torch.from_numpy(x["do"]).to(c["dtype"])
    grads = torch.autograd.grad(o, leaves, do)

    jseg = None if c["seg"] is None else tuple(jnp.asarray(s) for s in c["seg"])

    def oracle(q, k, v, *bias):
        return attention_reference(q, k, v, bias=bias[0] if bias else None, segment_ids=jseg,
                                   **kw)

    primals = [jnp.asarray(x[n]) for n in "qkv"] + ([] if x["bias"] is None
                                                    else [jnp.asarray(x["bias"])])
    want, vjp = jax.vjp(oracle, *primals)
    want_grads = vjp(jnp.asarray(x["do"]))
    assert o.dtype == c["dtype"]
    assert_close(o.float(), np.asarray(want), FWD_TOL[c["dtype"]], f"O {desc}")
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, want_grads):
        assert g.shape == w.shape, f"{name} {desc}"
        assert_close(g.float(), np.asarray(w), BWD_TOL[c["dtype"]], f"{name} {desc}")
