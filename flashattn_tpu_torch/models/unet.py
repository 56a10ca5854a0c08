"""SD-style latent-diffusion U-Net on the fused attention engine.

Port of flashattn_tpu/models/unet.py: a latent U-Net with ResBlocks and
SpatialTransformer blocks (self-attention + cross-attention + GEGLU) whose
every attention goes through :func:`scaled_dot_product_attention` in the
``[B, N, H, D]`` layout, as in the JAX model. Latents stay NHWC ``[B,H,W,C]``
at the public function.

The parameter tree mirrors the JAX pytree: ``state_dict()`` keys are the JAX
dict paths joined with dots (``downs.0.blocks.0.res.conv1.w``). Dense weights
keep the JAX ``[in, out]`` layout; conv weights are stored OIHW, as torch
convolutions want them (the JAX tree holds HWIO; models/convert.py maps it).

Numerics follow the JAX model: group and layer norm in f32 with eps 1e-5 and
population variance, tanh-approximated GELU (``jax.nn.gelu``'s default),
``padding="SAME"`` convolutions (a stride-2 3x3 conv on an even size pads
(0, 1), not torch's symmetric 1), ``[cos, sin]`` timestep embeddings, nearest
x2 upsampling and ``[h, skip]`` channel concatenation. (A float32 model's
convolutions on a GPU follow ``torch.backends.cudnn.allow_tf32``, True by
default; the serving path runs in bf16.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from flashattn_tpu_torch.ops.oracle import attention_reference
from flashattn_tpu_torch.ops.sdpa import scaled_dot_product_attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Sequence[int] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_levels: Sequence[int] = (0, 1, 2)   # levels with transformer blocks
    # int = uniform; or one entry per level (SDXL uses (1, 2, 10))
    transformer_depth: int | Sequence[int] = 1
    num_heads: int = 8
    # if set, heads are computed as C // head_dim per level (SDXL: 64)
    head_dim: int | None = None
    context_dim: int = 768
    groups: int = 32
    dtype: torch.dtype = torch.bfloat16
    # SD zero-initializes residual-branch output projections; disable when
    # the output must depend on every layer (at zero-init the attention
    # blocks and the output conv contribute exactly nothing).
    zero_init: bool = True

    def depth_at(self, level: int) -> int:
        d = self.transformer_depth
        return d if isinstance(d, int) else d[level]

    def heads_for(self, channels: int) -> int:
        if self.head_dim is not None:
            if channels % self.head_dim:
                raise ValueError(f"channels {channels} not a multiple of head_dim {self.head_dim}")
            return channels // self.head_dim
        return self.num_heads

    @staticmethod
    def sd15():
        """SD1.5 U-Net shape class."""
        return UNetConfig()

    @staticmethod
    def sdxl():
        """SDXL-base U-Net shape class: attention only at the 2x and 4x
        levels, per-level transformer depth (1, 2, 10), fixed 64-dim heads,
        2048-dim text conditioning."""
        return UNetConfig(
            channel_mult=(1, 2, 4), attn_levels=(1, 2),
            transformer_depth=(1, 2, 10), head_dim=64, context_dim=2048,
        )

    @staticmethod
    def tiny():
        """Test-sized config (same structure, small widths, f32)."""
        return UNetConfig(
            model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attn_levels=(0, 1), num_heads=2, context_dim=32, groups=8,
            dtype=torch.float32, zero_init=False,
        )


# ───────────────────────────── layers ───────────────────────────────────────


class Dense(nn.Module):
    """``x @ w + b`` with ``w [in, out]`` (the JAX layout)."""

    def __init__(self, cin, cout, dtype, device=None, zero=False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cin, cout, dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros(cout, dtype=dtype, device=device))
        self.zero = zero

    def forward(self, x):
        return F.linear(x, self.w.to(x.dtype).t(), self.b.to(x.dtype))


class Conv(nn.Module):
    """Square ``padding="SAME"`` convolution on NHWC input, ``w`` OIHW."""

    def __init__(self, cin, cout, ksize, dtype, device=None, zero=False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cout, cin, ksize, ksize, dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros(cout, dtype=dtype, device=device))
        self.zero = zero

    def forward(self, x, stride=1):
        k = self.w.shape[-1]
        xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
        pads = []
        for n in xc.shape[-2:]:
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            pads.append((total // 2, total - total // 2))
        if all(lo == hi for lo, hi in pads):
            padding = (pads[0][0], pads[1][0])
        else:  # SAME pads the extra pixel at the end: (0, 1) for k3 s2 on even sizes
            xc = F.pad(xc, (*pads[1], *pads[0]))
            padding = 0
        y = F.conv2d(xc, self.w.to(x.dtype), self.b.to(x.dtype), stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1)


class Norm(nn.Module):
    """Scale and bias of a group or layer norm, kept in f32."""

    def __init__(self, c, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=torch.float32, device=device))


def _group_norm(x, norm: Norm, groups, eps=1e-5):
    """f32 group norm (population variance) of NHWC ``x``, back in x.dtype."""
    y = F.group_norm(x.float().permute(0, 3, 1, 2), groups, norm.scale, norm.bias, eps)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _layer_norm(x, norm: Norm, eps=1e-5):
    return F.layer_norm(x.float(), x.shape[-1:], norm.scale, norm.bias, eps).to(x.dtype)


def _silu_f32(x):
    return F.silu(x.float()).to(x.dtype)


def _gelu_f32(x):
    """``jax.nn.gelu``'s default: the tanh approximation, here in f32."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def _upsample_nearest2x(x):
    """Nearest-neighbour x2 resize of NHWC ``x`` (output pixel i reads i // 2)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal timestep embedding, [B] -> [B, dim], ``[cos, sin]``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, temb_dim, dtype, zero_init, device=None):
        super().__init__()
        self.norm1 = Norm(cin, device)
        self.conv1 = Conv(cin, cout, 3, dtype, device)
        self.temb = Dense(temb_dim, cout, dtype, device)
        self.norm2 = Norm(cout, device)
        self.conv2 = Conv(cout, cout, 3, dtype, device, zero=zero_init)
        self.skip = Conv(cin, cout, 1, dtype, device) if cin != cout else None

    def forward(self, x, temb, groups):
        h = self.conv1(_silu_f32(_group_norm(x, self.norm1, groups)))
        h = h + self.temb(F.silu(temb))[:, None, None, :].to(h.dtype)
        h = self.conv2(_silu_f32(_group_norm(h, self.norm2, groups)))
        skip = self.skip(x) if self.skip is not None else x
        return skip + h


class Attention(nn.Module):
    def __init__(self, c, ctx_dim, dtype, device=None):
        super().__init__()
        self.wq = Dense(c, c, dtype, device)
        self.wk = Dense(ctx_dim, c, dtype, device)
        self.wv = Dense(ctx_dim, c, dtype, device)
        self.wo = Dense(c, c, dtype, device)

    def forward(self, x, ctx, heads, attn_impl):
        """x [B, N, C] (queries), ctx [B, M, Cctx] (keys/values).

        ``attn_impl``: "fused" routes through the SDPA adapter (the kernel
        where its shape rule picks it); "xla" computes exact unfused softmax
        attention, the baseline arm (named after the JAX model's arm)."""
        B, N, C = x.shape
        d = C // heads
        q = self.wq(x).reshape(B, N, heads, d)
        k = self.wk(ctx).reshape(B, ctx.shape[1], heads, d)
        v = self.wv(ctx).reshape(B, ctx.shape[1], heads, d)
        if attn_impl == "xla":
            o = attention_reference(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
        elif attn_impl == "fused":
            o = scaled_dot_product_attention(q, k, v, layout="BNHD")
        else:
            raise ValueError(f"unknown attn_impl {attn_impl!r} (expected 'fused' or 'xla')")
        return self.wo(o.reshape(B, N, C))


class TransformerBlock(nn.Module):
    def __init__(self, c, ctx_dim, dtype, device=None):
        super().__init__()
        self.ln1 = Norm(c, device)
        self.attn1 = Attention(c, c, dtype, device)          # self
        self.ln2 = Norm(c, device)
        self.attn2 = Attention(c, ctx_dim, dtype, device)    # cross
        self.ln3 = Norm(c, device)
        self.ff_in = Dense(c, 8 * c, dtype, device)          # GEGLU: 2×4c
        self.ff_out = Dense(4 * c, c, dtype, device)

    def forward(self, x, ctx, heads, attn_impl):
        h = _layer_norm(x, self.ln1)
        x = x + self.attn1(h, h, heads, attn_impl)
        x = x + self.attn2(_layer_norm(x, self.ln2), ctx, heads, attn_impl)
        a, g = self.ff_in(_layer_norm(x, self.ln3)).chunk(2, dim=-1)
        return x + self.ff_out(a * _gelu_f32(g))


class SpatialTransformer(nn.Module):
    def __init__(self, c, depth, ctx_dim, dtype, zero_init, device=None):
        super().__init__()
        self.norm = Norm(c, device)
        self.proj_in = Dense(c, c, dtype, device)
        self.blocks = nn.ModuleList(
            TransformerBlock(c, ctx_dim, dtype, device) for _ in range(depth))
        self.proj_out = Dense(c, c, dtype, device, zero=zero_init)

    def forward(self, x, ctx, cfg, attn_impl):
        B, H, W, C = x.shape
        heads = cfg.heads_for(C)
        h = self.proj_in(_group_norm(x, self.norm, cfg.groups).reshape(B, H * W, C))
        for blk in self.blocks:
            h = blk(h, ctx, heads, attn_impl)
        return x + self.proj_out(h).reshape(B, H, W, C)


class UNet(nn.Module):
    """The U-Net's parameters, laid out as the JAX pytree of ``init_unet``, on
    ``device`` (the card by default; the blocks inside take it from here).
    Parameters are allocated uninitialised: use :func:`init_unet` or
    ``models.convert.unet_from_jax``."""

    def __init__(self, cfg: UNetConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        mc, dt = cfg.model_channels, cfg.dtype
        temb_dim = 4 * mc

        def transformer(c, level):
            return SpatialTransformer(c, cfg.depth_at(level), cfg.context_dim, dt,
                                      cfg.zero_init, device)

        self.time_mlp1 = Dense(mc, temb_dim, dt, device)
        self.time_mlp2 = Dense(temb_dim, temb_dim, dt, device)
        self.conv_in = Conv(cfg.in_channels, mc, 3, dt, device)

        downs, ch, level_ch = [], mc, [mc]
        for level, mult in enumerate(cfg.channel_mult):
            cout = mc * mult
            blocks = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                blk = nn.ModuleDict(
                    {"res": ResBlock(ch, cout, temb_dim, dt, cfg.zero_init, device)})
                if level in cfg.attn_levels:
                    blk["attn"] = transformer(cout, level)
                blocks.append(blk)
                ch = cout
                level_ch.append(ch)
            down = nn.ModuleDict({"blocks": blocks})
            if level < len(cfg.channel_mult) - 1:
                down["downsample"] = Conv(ch, ch, 3, dt, device)
                level_ch.append(ch)
            downs.append(down)
        self.downs = nn.ModuleList(downs)

        self.mid = nn.ModuleDict({
            "res1": ResBlock(ch, ch, temb_dim, dt, cfg.zero_init, device),
            "attn": transformer(ch, len(cfg.channel_mult) - 1),
            "res2": ResBlock(ch, ch, temb_dim, dt, cfg.zero_init, device),
        })

        ups = []
        for level in reversed(range(len(cfg.channel_mult))):
            cout = mc * cfg.channel_mult[level]
            blocks = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                skip = level_ch.pop()
                blk = nn.ModuleDict(
                    {"res": ResBlock(ch + skip, cout, temb_dim, dt, cfg.zero_init, device)})
                if level in cfg.attn_levels:
                    blk["attn"] = transformer(cout, level)
                blocks.append(blk)
                ch = cout
            up = nn.ModuleDict({"blocks": blocks})
            if level > 0:
                up["upsample"] = Conv(ch, ch, 3, dt, device)
            ups.append(up)
        self.ups = nn.ModuleList(ups)

        self.norm_out = Norm(ch, device)
        self.conv_out = Conv(ch, cfg.out_channels, 3, dt, device, zero=cfg.zero_init)

    def forward(self, x, t, context, attn_impl="fused"):
        return unet_forward(self, x, t, context, self.cfg, attn_impl=attn_impl)


def init_unet(cfg: UNetConfig, generator: torch.Generator, device="cuda") -> UNet:
    """A U-Net on ``device`` (the card by default) with the JAX package's
    initialisation: dense and conv weights
    ``normal · fan_in^-1/2`` (zero where SD zero-initialises and
    ``cfg.zero_init``), zero biases, unit norm scales. Draws come from
    ``generator`` on its own device."""
    unet = UNet(cfg, device=device)
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, (Dense, Conv)):
                if m.zero:
                    m.w.zero_()
                    continue
                shape = m.w.shape
                fan_in = shape[0] if isinstance(m, Dense) else math.prod(shape[1:])
                w = torch.randn(shape, generator=generator, dtype=torch.float32,
                                device=generator.device) * fan_in ** -0.5
                m.w.copy_(w)
    return unet


def unet_forward(unet: UNet, x, t, context, cfg: UNetConfig, *, attn_impl="fused"):
    """Denoise step: latents ``x [B,H,W,Cin]``, timesteps ``t [B]``,
    text conditioning ``context [B, M, ctx_dim]`` → ``eps [B,H,W,Cout]`` (f32)."""
    dt = cfg.dtype
    temb = timestep_embedding(t, cfg.model_channels)
    temb = unet.time_mlp2(_silu_f32(unet.time_mlp1(temb.to(dt))))

    x = x.to(dt)
    context = context.to(dt)
    h = unet.conv_in(x)
    skips = [h]
    for down in unet.downs:
        for blk in down["blocks"]:
            h = blk["res"](h, temb, cfg.groups)
            if "attn" in blk:
                h = blk["attn"](h, context, cfg, attn_impl)
            skips.append(h)
        if "downsample" in down:
            h = down["downsample"](h, stride=2)
            skips.append(h)

    h = unet.mid["res1"](h, temb, cfg.groups)
    h = unet.mid["attn"](h, context, cfg, attn_impl)
    h = unet.mid["res2"](h, temb, cfg.groups)

    for up in unet.ups:
        for blk in up["blocks"]:
            h = torch.cat([h, skips.pop()], dim=-1)
            h = blk["res"](h, temb, cfg.groups)
            if "attn" in blk:
                h = blk["attn"](h, context, cfg, attn_impl)
        if "upsample" in up:
            h = up["upsample"](_upsample_nearest2x(h))

    h = _silu_f32(_group_norm(h, unet.norm_out, cfg.groups))
    return unet.conv_out(h).float()
