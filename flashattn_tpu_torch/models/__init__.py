"""Model families served by the attention engine: the SD-style latent U-Net
(models/unet.py) and its Euler sampler (models/diffusion.py)."""

from flashattn_tpu_torch.models.unet import UNet, UNetConfig, init_unet, unet_forward

__all__ = ["UNet", "UNetConfig", "init_unet", "unet_forward"]
