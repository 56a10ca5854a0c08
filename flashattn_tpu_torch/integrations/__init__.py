"""Drop-in attention modules and functions for model code (port of
flashattn_tpu/integrations)."""

from flashattn_tpu_torch.integrations.torch_nn import (
    FlashMultiHeadDotProductAttention,
    flash_attention_fn,
    make_attention_mask,
    make_flash_attention_fn,
)

__all__ = [
    "FlashMultiHeadDotProductAttention",
    "flash_attention_fn",
    "make_attention_mask",
    "make_flash_attention_fn",
]
