"""The GPT-2 configuration files under the port's names."""

from __future__ import annotations


def dims(config: dict) -> dict:
    """The model's sizes under the port's names, from a configuration
    file that holds GPT-2's published keys."""
    d = int(config["n_embd"])
    return {"vocab_size": int(config["vocab_size"]), "d_model": d,
            "n_heads": int(config["n_head"]),
            "n_layers": int(config["n_layer"]),
            "d_ff": int(config.get("n_inner") or 4 * d),
            "max_len": int(config["n_positions"])}


def transformer_config(dm: dict, dtype):
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=dm["vocab_size"],
                             d_model=dm["d_model"], n_heads=dm["n_heads"],
                             n_layers=dm["n_layers"], d_ff=dm["d_ff"],
                             max_len=dm["max_len"], dtype=dtype)
