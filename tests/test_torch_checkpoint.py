"""The port's checkpoint module (utils/checkpoint.py) on CPU: the round trip,
``restore(like=)``'s dtype / device and its errors (the JAX module's
``ValueError`` on a structure or shape mismatch, flashattn_tpu/utils/
checkpoint.py:65-83), ``latest_step_dir`` against the JAX function on the
same directory tree, and the tiny LM of tests/test_models.py -- its weights
from the JAX ``init_transformer`` through ``transformer_from_jax`` --
trained two AdamW steps, checkpointed, resumed into a fresh model and a
fresh AdamW state: its third step's loss and parameters equal the
uninterrupted run's bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import transformer as jax_lm
from flashattn_tpu.utils import checkpoint as jax_ckpt
from flashattn_tpu_torch.models import transformer as lm
from flashattn_tpu_torch.models.convert import transformer_from_jax
from flashattn_tpu_torch.utils import checkpoint as ckpt

WIDTH = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=32,
             d_ff=128)
TOKENS = np.random.default_rng(1).integers(0, 128, (2, 65)).astype(np.int32)


def _state():
    rng = np.random.default_rng(2)
    return {"params": {"w": torch.from_numpy(rng.standard_normal((3, 4), dtype=np.float32)),
                       "b": torch.from_numpy(rng.standard_normal(4, dtype=np.float32))
                       .to(torch.bfloat16)},
            "opt": {"mu": [torch.zeros(3, 4), torch.ones(2)], "count": 7},
            "step": 100, "lr": 1e-3, "ids": torch.arange(5), "pair": (torch.zeros(2), 3)}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("like", [False, True])
def test_round_trip(tmp_path, like):
    state = _state()
    path = ckpt.save(str(tmp_path / "ck" / "state.pt"), state)
    assert path == str(tmp_path / "ck" / "state.pt")
    assert _equal(ckpt.restore(path, like=state if like else None), state)


def test_restore_takes_like_dtype_and_device(tmp_path):
    state = _state()
    path = ckpt.save(str(tmp_path / "state.pt"), state)
    like = _state()
    like["params"]["w"] = like["params"]["w"].to(torch.float16)
    like["params"]["b"] = like["params"]["b"].to(torch.float32)
    got = ckpt.restore(path, like=like)
    assert got["params"]["w"].dtype == torch.float16
    assert torch.equal(got["params"]["w"], state["params"]["w"].to(torch.float16))
    assert got["params"]["b"].dtype == torch.float32
    assert torch.equal(got["params"]["b"], state["params"]["b"].float())
    assert got["opt"]["count"] == 7 and got["step"] == 100


def test_save_without_force_keeps_the_file(tmp_path):
    path = ckpt.save(str(tmp_path / "state.pt"), {"x": torch.zeros(2)})
    with pytest.raises(FileExistsError):
        ckpt.save(path, {"x": torch.ones(2)}, force=False)
    assert torch.equal(ckpt.restore(path)["x"], torch.zeros(2))
    ckpt.save(path, {"x": torch.ones(2)})
    assert torch.equal(ckpt.restore(path)["x"], torch.ones(2))


@pytest.mark.parametrize("change", ["extra leaf", "missing leaf", "renamed leaf"])
def test_structure_mismatch_raises(tmp_path, change):
    state = _state()
    path = ckpt.save(str(tmp_path / "state.pt"), state)
    like = _state()
    if change == "extra leaf":
        like["opt"]["mu"].append(torch.zeros(1))
    elif change == "missing leaf":
        del like["lr"]
    else:
        like["params"]["v"] = like["params"].pop("w")
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(path, like=like)


def test_shape_mismatch_raises(tmp_path):
    path = ckpt.save(str(tmp_path / "state.pt"), _state())
    like = _state()
    like["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match=r"saved shape \(3, 4\) != `like` shape \(4, 3\)"):
        ckpt.restore(path, like=like)


def test_latest_step_dir_matches_jax(tmp_path):
    root = tmp_path / "run"
    assert ckpt.latest_step_dir(str(root)) is None
    assert jax_ckpt.latest_step_dir(str(root)) is None
    root.mkdir()
    assert ckpt.latest_step_dir(str(root)) == jax_ckpt.latest_step_dir(str(root)) is None
    for name in ("9", "100", "20", "latest", "7b"):
        (root / name).mkdir()
    assert ckpt.latest_step_dir(str(root)) == jax_ckpt.latest_step_dir(str(root))
    assert ckpt.latest_step_dir(str(root)) == str(root / "100")


def _steps(model, params, state, cfg, n):
    """``n`` AdamW steps: their losses and the AdamW state after them."""
    losses = []
    for _ in range(n):
        model.zero_grad(set_to_none=True)
        loss = lm.lm_loss(model, torch.from_numpy(TOKENS).long(), cfg)
        loss.backward()
        state = lm.adamw_update({n: p.grad for n, p in params.items()}, state, params,
                                lr=1e-2)[1]
        losses.append(loss.item())
    return losses, state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_resumes_from_a_checkpoint_bit_for_bit(tmp_path, dtype):
    """Three AdamW steps of the tiny LM against two, a checkpoint of the
    parameters and the AdamW state under latest_step_dir's layout, a fresh
    model and state restored from it (``like=`` the fresh ones), and the
    third step: the same loss and parameters, bit for bit."""
    jcfg = jax_lm.TransformerConfig(**WIDTH, dtype=jnp.float32)
    cfg = lm.TransformerConfig(**WIDTH, dtype=dtype)
    jax_params = jax.tree_util.tree_map(np.asarray,
                                        jax_lm.init_transformer(jax.random.PRNGKey(0), jcfg))

    def fresh():
        model = transformer_from_jax(jax_params, cfg, device="cpu")
        params = dict(model.named_parameters())
        return model, params, lm.adamw_init(params)

    model, params, state = fresh()
    losses, _ = _steps(model, params, state, cfg, 3)
    want = {n: p.detach().clone() for n, p in params.items()}

    model, params, state = fresh()
    first, state = _steps(model, params, state, cfg, 2)
    assert first == losses[:2]
    ckpt.save(str(tmp_path / "2" / "state.pt"), {"params": params, "opt": state, "step": 2})

    model, params, state = fresh()
    latest = ckpt.latest_step_dir(str(tmp_path))
    got = ckpt.restore(f"{latest}/state.pt", like={"params": params, "opt": state, "step": 0})
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(got["params"][n])
    state = got["opt"]
    assert got["step"] == 2 and state["count"] == 2
    assert all(p.dtype == dtype for p in params.values())
    assert _steps(model, params, state, cfg, 1)[0] == losses[2:]
    for n, p in params.items():
        assert torch.equal(p.detach(), want[n]), n


def test_checkpoint_keeps_no_autograd_graph(tmp_path):
    """A parameter that requires grad is saved detached and comes back as
    plain data."""
    w = torch.nn.Parameter(torch.ones(3))
    path = ckpt.save(str(tmp_path / "w.pt"), {"w": w * 2})
    got = ckpt.restore(path)["w"]
    assert not got.requires_grad and torch.equal(got, torch.full((3,), 2.0))


@dataclasses.dataclass
class _Opaque:
    x: int = 1


def test_restore_reads_data_only(tmp_path):
    """restore unpickles with weights_only: a checkpoint that holds an
    arbitrary object is refused, not executed."""
    path = tmp_path / "opaque.pt"
    torch.save({"x": _Opaque()}, path)
    with pytest.raises(Exception, match="weights_only|Unsupported global"):
        ckpt.restore(str(path))
