"""Model families served by the attention engine: the SD-style latent U-Net
(models/unet.py) and its Euler sampler (models/diffusion.py), and the
Llama-class LM with its AdamW step and KV-cache decode (models/transformer.py)."""

from flashattn_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, decode_step, init_kv_cache, init_transformer, lm_loss,
    transformer_forward,
)
from flashattn_tpu_torch.models.unet import UNet, UNetConfig, init_unet, unet_forward

__all__ = ["Transformer", "TransformerConfig", "decode_step", "init_kv_cache",
           "init_transformer", "lm_loss", "transformer_forward", "UNet", "UNetConfig",
           "init_unet", "unet_forward"]
