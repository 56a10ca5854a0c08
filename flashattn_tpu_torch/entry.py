"""Entry points of the port: a single-device denoise step and a multi-rank dry run.

The port's counterpart of ``__graft_entry__.py`` (which imports JAX and stays
as it is). ``entry()`` returns the SD1.5-class U-Net's denoise step with
example arguments; ``dryrun_multichip(n)`` runs one dp x tp x sp training
step of the LM over an ``n``-rank mesh, contiguous and packed, and for n >= 8
on a two-slice mesh, at tiny shapes in f32, as the JAX function builds it.
Both run on the card unless given ``device="cpu"``. Run as a script::

    python -m flashattn_tpu_torch.entry              # entry(): one denoise step
    python -m flashattn_tpu_torch.entry multichip 8  # dryrun_multichip(8)
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.models.transformer import (
    TransformerConfig,
    adamw_init,
    init_transformer,
    make_sharded_train_step,
    shard_params,
)
from flashattn_tpu_torch.models.unet import UNetConfig, init_unet, unet_forward
from flashattn_tpu_torch.parallel import make_mesh


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def entry_config() -> UNetConfig:
    """The U-Net of ``__graft_entry__.entry`` (``__graft_entry__.py:30-33``):
    SD1.5's structure at 192 base channels, bf16, zero-initialised residual
    outputs."""
    return UNetConfig(model_channels=192, channel_mult=(1, 2, 4), num_res_blocks=2,
                      attn_levels=(0, 1, 2), num_heads=8, context_dim=768)


def entry(device=None, cfg: UNetConfig | None = None):
    """``(fn, args)``: the U-Net denoise step ``fn(unet, x, t, context)`` of
    ``__graft_entry__.entry`` (its config, seeded weights, latents ``x [1,
    32, 32, 4]`` f32, ``t = [500.]`` and a ``[1, 77, 768]`` context) and
    its example arguments, on ``device`` (the card by default); ``cfg``
    replaces :func:`entry_config` (a narrower U-Net for a quick check).
    ``fn`` returns the predicted noise ``[1, 32, 32, 4]`` f32.

    At this size every attention call takes the exact path: the SDPA
    adapter's rule (``ops/sdpa.py:17-20``, the JAX package's) sends the
    1024-token and smaller self-attention and the 77-token cross-attention to
    the exact oracle, as the JAX rule does, so the step launches no attention
    kernel. The weights, like the JAX step's, zero-initialise the residual
    outputs, so the step's output is exactly 0."""
    dev = _device(device)
    cfg = entry_config() if cfg is None else cfg
    unet = init_unet(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((1, 32, 32, 4), generator=gen, device=dev)
    t = torch.tensor([500.0], device=dev)
    ctx = torch.randn((1, 77, 768), generator=gen, device=dev)

    def fn(unet, x, t, ctx):
        with torch.no_grad():
            return unet_forward(unet, x, t, ctx, cfg)

    return fn, (unet, x, t, ctx)


def _factor_mesh(n: int):
    """n devices -> (data, model, seq), preferring seq > model > data (the
    JAX function, ``__graft_entry__.py:46-58``)."""
    def largest_pow2_divisor(x, cap):
        d = 1
        while d * 2 <= cap and x % (d * 2) == 0:
            d *= 2
        return d

    seq = largest_pow2_divisor(n, 4)
    rest = n // seq
    model = largest_pow2_divisor(rest, 2)
    data = rest // model
    return data, model, seq


def lm_config(model: int) -> TransformerConfig:
    """The dry run's LM (``__graft_entry__.py:99-103``) for a ``model`` axis
    of that size: two layers, d_model 64, 2·model query heads over model KV
    heads of 32, in f32."""
    return TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=2 * model,
                             n_kv_heads=model, d_head=32, d_ff=64 * model, dtype=torch.float32)


def run(mesh, data: int, model: int, seq: int, *, slices: int = 1, packed: bool = False,
        lm=None, tokens=None) -> float:
    """One lr=1e-3 training step of :func:`lm_config` ``(model)`` over
    ``mesh`` through ``make_sharded_train_step``, and its loss (the JAX
    ``run`` of ``__graft_entry__.py:98-121``). ``lm``: the unsharded
    :class:`Transformer` to start from (default: seed-0 weights); ``tokens``:
    the ``[max(2, 2·data·slices), 128·seq]`` batch (default: seed-1 tokens).
    ``packed``: two documents a row, the boundary at ``n / 2 + 17``,
    straddling the seq shards."""
    cfg = lm_config(model)
    dev = mesh.device
    if lm is None:
        lm = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = shard_params(lm, mesh)
    opt = [adamw_init(p) for p in params]
    step, _, _ = make_sharded_train_step(mesh, cfg, lr=1e-3, with_segment_ids=packed)
    n = 128 * seq
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (max(2, 2 * data * slices), n),
                               generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    tokens = tokens.to(dev)
    extra = ()
    if packed:
        seg = (torch.arange(n, device=dev)[None] >= n // 2 + 17).to(torch.int32)
        extra = (seg.expand(tokens.shape).contiguous(),)
    _, _, loss = step(params, opt, tokens, *extra)
    return float(loss)


def dryrun_multichip(n_devices: int, device=None) -> list[float]:
    """One dp x tp x sp training step over an ``n_devices``-rank mesh
    (``__graft_entry__.dryrun_multichip``): the mesh of :func:`_factor_mesh`,
    a contiguous step and a packed one, and for n >= 8 (even) a ``slices=2``
    mesh, each printing its line. The ranks are a ``VirtualMesh`` on
    ``device`` (the card by default) unless a process group of more than one
    rank is initialised. Returns the losses in that order."""
    data, model, seq = _factor_mesh(n_devices)
    dev = _device(device)
    mesh = make_mesh(data=data, model=model, seq=seq, devices=dev)
    loss = run(mesh, data, model, seq)
    print(f"dryrun_multichip OK: mesh data={data} model={model} seq={seq}, loss={loss:.4f}")
    loss_p = run(mesh, data, model, seq, packed=True)
    print(f"dryrun_multichip OK (packed segment_ids): loss={loss_p:.4f}")
    losses = [loss, loss_p]
    if n_devices >= 8 and n_devices % 2 == 0:
        # The slice axis outermost, the others inside it (the JAX function's
        # 2-level slice x chip topology); the LM keeps the outer model width.
        s_model = max(1, model // 2) if seq * model >= 4 else model
        s_seq = (n_devices // 2) // s_model
        mesh2 = make_mesh(data=1, model=s_model, seq=s_seq, slices=2, devices=dev)
        loss2 = run(mesh2, 1, model, seq, slices=2)
        print(f"dryrun_multichip OK: mesh slice=2 data=1 model={s_model} seq={s_seq}, "
              f"loss={loss2:.4f}")
        losses.append(loss2)
    return losses


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "multichip":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        step_fn, step_args = entry()
        out = step_fn(*step_args)
        if out.is_cuda:
            torch.cuda.synchronize()
        print("entry OK:", tuple(out.shape), out.dtype)
