"""Diffusion sampling loop (Euler) over the U-Net (port of flashattn_tpu/models/diffusion.py).

A Karras sigma schedule and Euler integration over :func:`unet_forward`; one
"it" is one U-Net denoise step. The JAX version runs the loop as one jitted
``lax.scan``; here it is a Python loop of eager steps. The latent stays f32
whatever the model's dtype, as in JAX.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.models.unet import UNet, UNetConfig, unet_forward


def karras_sigmas(n: int, sigma_min=0.0292, sigma_max=14.6146, rho=7.0) -> torch.Tensor:
    """``n`` Karras sigmas from ``sigma_max`` down to ``sigma_min``, then 0 (f32, CPU)."""
    ramp = torch.linspace(0, 1, n)
    min_r, max_r = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    sigmas = (max_r + ramp * (min_r - max_r)) ** rho
    return torch.cat([sigmas, torch.zeros(1)])


def sigma_to_t(sigma: torch.Tensor) -> torch.Tensor:
    """Continuous timestep for the karras-style eps model (log-sigma)."""
    return 0.25 * torch.log(torch.clamp(sigma, min=1e-10)) * 100.0 + 500.0


@torch.no_grad()
def euler_sample(unet: UNet, context: torch.Tensor, *, cfg: UNetConfig, shape,
                 steps: int = 20, generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None, attn_impl: str = "fused") -> torch.Tensor:
    """Euler sampling: returns the final latent ``[B, H, W, C]`` (f32) on
    ``context``'s device.

    eps-prediction model: dx/dσ = (x − denoised)/σ with
    denoised = x − σ·eps(x/√(σ²+1), t(σ)). The start is ``noise · σ_0``,
    where ``noise`` is a standard-normal draw of ``shape``: passed in, or
    drawn from ``generator`` on its device.
    """
    shape = tuple(shape)
    device = context.device
    if noise is None:
        noise = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device if generator is not None else device)
    if tuple(noise.shape) != shape:
        raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
    sigmas = karras_sigmas(steps)
    x = noise.to(device=device, dtype=torch.float32) * sigmas[0]
    for i in range(steps):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        c_in = torch.rsqrt(sigma ** 2 + 1.0)
        t = sigma_to_t(sigma).expand(shape[0]).to(device)
        eps = unet_forward(unet, x * c_in, t, context, cfg, attn_impl=attn_impl)
        x = x + (sigma_next - sigma) * eps
    return x
