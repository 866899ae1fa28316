"""Tiny cells for the CPU tests: the same runners and checks as the
benchmark's cells, at sizes a test run holds."""

import json

from harness import common

BENCH = common.ROOT / "BENCHMARK.json"

GPT_TINY = {"model_type": "gpt2", "vocab_size": 512, "n_embd": 64, "n_head": 2, "n_layer": 2,
            "n_positions": 256, "torch_dtype": "float32",
            "serving": {"slots": 4, "page_size": 16, "kv_pages": 64,
                        "prefix_cache": True, "horizon": 1}}


def metrics_for(workload: str):
    bench = json.loads(BENCH.read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    per = [m for m in bench["per_layer"]
           if "workloads" not in m or workload in m["workloads"]]
    return e2e, per


def serve_spec(workload="gpt2-medium.serve.batch_decode", **mix):
    traffic = {"kind": "serve", "backlog": 2,
               "prompt": {"dist": "loguniform", "low": 16, "high": 40},
               "output": {"dist": "uniform", "low": 6, "high": 12},
               "warmup_s": 0.3, "trace_s": 0.3, "sample_tokens": 24}
    traffic.update(mix)
    e2e, per = metrics_for(workload)
    return common.Spec.from_parts(
        workload, 1, dict(GPT_TINY), traffic,
        {"max_logit_gap": 1e-3, "min_judged": 16}, e2e, per)


MLP_TINY = {"layer_sizes": [784, 64, 32, 10], "activation_function": "relu",
            "output_activation": "softmax", "loss_function": "mcxent",
            "updater": "adagrad", "lr": 0.05, "momentum": 0.5,
            "weight_init": "vi", "compute_dtype": "float32",
            "param_dtype": "float32", "batch_size": 256, "ranks": 4,
            "rows_per_rank": 64}


def dp_spec(workload="mnist-mlp.train.dp4", **mix):
    traffic = {"kind": "train_dp", "zero_share": 0.8, "checked_steps": 3,
               "pool_batches": 2, "trace_s": 0.3}
    traffic.update(mix)
    e2e, per = metrics_for(workload)
    return common.Spec.from_parts(
        workload, 4, dict(MLP_TINY), traffic,
        {"loss_gap": 1e-5, "first_grad_gap": 1e-4, "change_gap": 1e-4},
        e2e, per)
