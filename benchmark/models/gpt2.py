"""GPT-2 served through the port's transformer
(`InferenceEngine.for_transformer`): the configuration's GPT-2 keys
under the port's names (`harness.lm`), the weights of
`harness.weights.gpt2_params`, and the plain reference
`reference/gpt2.py`."""

from __future__ import annotations

from harness import lm, weights
from reference import gpt2 as ref

dims = lm.dims
make_params = weights.gpt2_params


def make_engine(params, dims: dict, dtype, device, serving: dict):
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

    return InferenceEngine.for_transformer(
        params, lm.transformer_config(dims, dtype), device=device,
        decode_slots=int(serving["slots"]),
        page_size=int(serving["page_size"]),
        kv_pages=int(serving["kv_pages"]),
        prefix_cache=bool(serving.get("prefix_cache", True)),
        horizon=int(serving.get("horizon", 1)))


def reference_params(dims: dict, seed: int, device, dtype):
    return weights.to_float32(weights.gpt2_params(dims, seed, device, dtype))


def served_gaps(params32, dims: dict, prompt, served,
                precision: str = "float32", ref_logits=None):
    return ref.served_gaps(params32, dims["n_heads"], prompt, served,
                           precision, ref_logits)
