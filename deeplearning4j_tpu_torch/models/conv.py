"""Convolution + max-pool layer, the counterpart of the JAX package's
`models/conv.py`.

Parity: reference core/nn/layers/convolution/
ConvolutionDownSampleLayer.java:52-88 (conv2d VALID -> maxPool(stride)
-> per-feature-map bias -> activation), parameters named as in the JAX
package ("W" HWIO filters, "b" one bias per output map).

NHWC in and out with HWIO filters, so weights cross between the packages
unchanged. The stride-1 VALID conv is a patch stack and one product, as
in the JAX package: `unfold` gathers each output pixel's fh x fw x C_in
window in the order (dh * fw + dw) * C_in + ci, the order in which the
HWIO filter reshapes to (fh * fw * C_in, C_out); the product runs in
`conf.compute_dtype` with a float32 result (`ops/products.py`). Pooling
is a crop, a reshape and `amax`, whose gradient splits evenly among
tied maxima as jax's `max` does (`F.max_pool2d` would give all of it to
one index).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.layers import (BaseLayer, apply_dropout,
                                                register_layer, torch_dtype)
from deeplearning4j_tpu_torch.ops.activations import apply_activation
from deeplearning4j_tpu_torch.ops.products import matmul_f32


@register_layer("conv")
class ConvolutionDownSampleLayer(BaseLayer):
    """conv2d (VALID) + max-pool + bias + activation, NHWC.

    Config: `filter_size=[fh, fw]`, `num_in_feature_maps` (C_in),
    `num_feature_maps` (C_out), `stride=[sh, sw]` (pool window AND
    stride, the reference's Transforms.maxPool semantics).
    """

    def _filter_hw(self):
        fs = self.conf.filter_size or [2, 2]
        return int(fs[0]), int(fs[1])

    def _pool_hw(self):
        st = self.conf.stride or [2, 2]
        return int(st[0]), int(st[1])

    def param_shapes(self) -> Dict[str, tuple]:
        c = self.conf
        fh, fw = self._filter_hw()
        return {"W": (fh, fw, c.num_in_feature_maps, c.num_feature_maps),
                "b": (c.num_feature_maps,)}

    def activate(self, params, x, *, rng: Optional[torch.Generator] = None,
                 training: bool = False):
        c = self.conf
        fh, fw = self._filter_hw()
        if x.dim() != 4:
            raise ValueError(f"conv input must be NHWC, got shape "
                             f"{tuple(x.shape)}")
        if x.shape[3] != c.num_in_feature_maps:
            raise ValueError(
                f"Input feature maps {x.shape[3]} != configured "
                f"num_in_feature_maps {c.num_in_feature_maps}")
        if x.shape[1] < fh or x.shape[2] < fw:
            raise ValueError(f"Filter {fh}x{fw} larger than input "
                             f"{x.shape[1]}x{x.shape[2]}")
        cd = torch_dtype(c.compute_dtype)
        b, h, w, cin = x.shape
        oh, ow = h - fh + 1, w - fw + 1
        # (B, oh, ow, C, fh, fw) windows -> (B, oh, ow, fh * fw * C)
        patches = (x.to(cd).unfold(1, fh, 1).unfold(2, fw, 1)
                   .permute(0, 1, 2, 4, 5, 3).reshape(b, oh, ow,
                                                      fh * fw * cin))
        w_flat = params["W"].to(cd).reshape(-1, c.num_feature_maps)
        conv = matmul_f32(patches, w_flat).to(torch_dtype(c.dtype))
        ph, pw = self._pool_hw()
        hh, ww = oh // ph * ph, ow // pw * pw
        pooled = conv[:, :hh, :ww, :].reshape(
            b, hh // ph, ph, ww // pw, pw, c.num_feature_maps).amax(dim=(2, 4))
        act = apply_activation(c.activation_function, pooled + params["b"])
        return apply_dropout(rng, act, c.dropout, training)


register_layer("convolution")(ConvolutionDownSampleLayer)
