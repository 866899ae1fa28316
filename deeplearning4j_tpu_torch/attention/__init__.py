"""Attention: the flash kernels (K1 forward, K2/K3 backward), the paged
decode kernel (K4), the blockwise plain forms, and the self_attention
layer of the layer registry."""

from deeplearning4j_tpu_torch.attention.blockwise import (blockwise_attention,
                                                          naive_attention)
from deeplearning4j_tpu_torch.attention.flash import (
    flash_attention, flash_attention_bwd_ref, flash_attention_ref,
    flash_attention_with_lse)
from deeplearning4j_tpu_torch.attention.layer import SelfAttentionLayer
from deeplearning4j_tpu_torch.attention.paged import (paged_attention,
                                                      paged_attention_ref,
                                                      resolve_decode_kernel)

__all__ = ["blockwise_attention", "naive_attention", "flash_attention",
           "flash_attention_bwd_ref", "flash_attention_ref",
           "flash_attention_with_lse", "paged_attention", "paged_attention_ref",
           "resolve_decode_kernel", "SelfAttentionLayer"]
