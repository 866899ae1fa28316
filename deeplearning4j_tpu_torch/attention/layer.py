"""Self-attention layer for the layer registry, the counterpart of the
JAX package's `attention/layer.py`: Wq/Wk/Wv projections, flash
attention over (B, H, T, d_head), and the Wo output projection, on
(batch, T, d_model) inputs.

The projections run in `conf.compute_dtype`; the attention output is
cast to `conf.dtype` before Wo. Attention is `attention/flash.py`'s
`flash_attention`: on a CUDA tensor the forward kernel (K1) and, under
autograd, the dQ and dK/dV kernels (K2, K3) through `_FlashAttention`;
on a CPU tensor their plain versions. The kernels take head dims 64
and 128 in float32 or bfloat16, so on a CUDA device any other head dim
or compute dtype raises when the layer is built, never at the first
forward and never by giving way to the plain version. On the CPU every
head dim runs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.attention import flash
from deeplearning4j_tpu_torch.nn.layers import (BaseLayer, apply_dropout,
                                                register_layer, torch_dtype)


@register_layer("self_attention")
class SelfAttentionLayer(BaseLayer):
    """Config: n_in = model dim, n_out = total attention dim (n_in if
    0), n_heads = attention heads (n_out divisible by it), `causal` =
    causal masking. None of the four weights is bias-named, so all take
    the weight-init scheme."""

    def __init__(self, conf, device=None):
        device = default_device(device)
        super().__init__(conf, device=device)
        _, d_attn, n_heads = self._dims()
        d_head = d_attn // n_heads
        cd = torch_dtype(conf.compute_dtype)
        if device.type == "cuda" and (
                d_head not in flash.KERNEL_HEAD_DIMS
                or cd not in flash.KERNEL_DTYPES):
            raise ValueError(
                f"self_attention on {device}: the flash kernels take head "
                f"dims {flash.KERNEL_HEAD_DIMS} in float32 or bfloat16, got "
                f"head dim {d_head} ({d_attn} / {n_heads} heads) in {cd}")

    def _dims(self):
        d_model = self.conf.n_in
        d_attn = self.conf.n_out or d_model
        n_heads = max(1, int(getattr(self.conf, "n_heads", 1)))
        if d_attn % n_heads:
            raise ValueError(f"attention dim {d_attn} not divisible by "
                             f"n_heads {n_heads}")
        return d_model, d_attn, n_heads

    def is_causal(self) -> bool:
        return bool(self.conf.causal)

    def param_shapes(self) -> Dict[str, tuple]:
        d_model, d_attn, _ = self._dims()
        return {"Wq": (d_model, d_attn), "Wk": (d_model, d_attn),
                "Wv": (d_model, d_attn), "Wo": (d_attn, d_model)}

    def activate(self, params, x, *, rng: Optional[torch.Generator] = None,
                 training: bool = False):
        """x: (B, T, d_model) -> (B, T, d_model)."""
        if x.dim() != 3:
            raise ValueError(f"self_attention expects (batch, time, dim), "
                             f"got {tuple(x.shape)}")
        _, d_attn, n_heads = self._dims()
        d_head = d_attn // n_heads
        b, t, _ = x.shape
        cd = torch_dtype(self.conf.compute_dtype)
        xc = x.to(cd)

        def heads(w):
            # (B, T, d_attn) -> (B, H, T, d_head)
            proj = xc @ w.to(cd)
            return proj.reshape(b, t, n_heads, d_head).transpose(1, 2)

        out = flash.flash_attention(heads(params["Wq"]), heads(params["Wk"]),
                                    heads(params["Wv"]), self.is_causal())
        out = out.transpose(1, 2).reshape(b, t, d_attn)
        out = out.to(torch_dtype(self.conf.dtype)) @ params["Wo"]
        return apply_dropout(rng, out, self.conf.dropout, training)
