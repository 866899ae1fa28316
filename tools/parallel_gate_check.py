"""Read chip_smoke.py's phase 19 (b) trainer gate on the CPU, at reduced
widths, for the package of any checkout.

BASELINE config 1's MLP cut to 784-1024-512-10 (bf16 products, AdaGrad
lr 0.05, 16 batches of 1,024 rows) trains 2 epochs under DataParallelTrainer ({"data": 4}) and
TensorParallelTrainer ({"data": 2, "model": 2}) over 4 forked gloo ranks.
Each result is held against one process's `MultiLayerNetwork.fit` as
||p - p_fit|| / ||p_fit - p0||, the distance in units of the training's
own movement, which is what the smoke gates at PAR_MOVE_TOL. Two
controls are printed beside them: a fit on a quarter of every batch and
no training at all (1 by definition).

Point `--repo` at a copy of the repository with a collective removed
(say, the gradient all-reduce of `parallel/data_parallel.py`) to see how
far the gate sits from a broken trainer:

    python3 tools/parallel_gate_check.py --repo /path/to/copy
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS, BATCH, BATCHES, RANKS = (1024, 512), 1024, 16, 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose deeplearning4j_tpu_torch to use")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    from deeplearning4j_tpu_torch import parallel
    from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.datasets import (DataSet,
                                                   ListDataSetIterator)
    from deeplearning4j_tpu_torch.datasets.mnist import synthetic_mnist
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.testing.ranks import run_ranks

    batch, n_batches, ranks = BATCH, BATCHES, RANKS
    x, y = synthetic_mnist(batch * n_batches, seed=19)
    cpu = torch.device("cpu")

    def conf():
        return (NeuralNetConfiguration.builder()
                .lr(0.05).n_in(784).activation_function("relu")
                .optimization_algo("iteration_gradient_descent")
                .num_iterations(1).batch_size(batch)
                .compute_dtype("bfloat16")
                .list(3).hidden_layer_sizes(list(WIDTHS))
                .override(2, layer="output", loss_function="mcxent",
                          activation_function="softmax", n_out=10)
                .pretrain(False).build())

    def fit(xs, ys, rows):
        net = MultiLayerNetwork(conf(), device=cpu)
        net.fit(ListDataSetIterator(DataSet(xs, ys), rows), epochs=2)
        return net.params().numpy()

    def trainer_rank(rank, name, axes):
        mesh = parallel.make_mesh(axes, device=cpu)
        net = MultiLayerNetwork(conf(), device=cpu)
        getattr(parallel, name)(net, mesh).fit(
            ListDataSetIterator(DataSet(x, y), batch), epochs=2)
        return net.params().numpy()

    p0 = MultiLayerNetwork(conf(), device=cpu).params().numpy()
    p_fit = fit(x, y, batch)
    quarter = np.concatenate([np.arange(i * batch, i * batch + batch // ranks)
                              for i in range(n_batches)])
    p_quarter = fit(x[quarter], y[quarter], batch // ranks)
    p_dp = run_ranks(trainer_rank, ranks, "DataParallelTrainer",
                     {"data": ranks}, timeout=600)[0]
    p_tp = run_ranks(trainer_rank, ranks, "TensorParallelTrainer",
                     {"data": 2, "model": 2}, timeout=600)[0]
    move = np.linalg.norm(p_fit.astype(np.float64) - p0)

    def rel(p, ref=p_fit):
        return float(np.linalg.norm(p.astype(np.float64) - ref) / move)

    print(json.dumps({
        "repo": os.path.abspath(args.repo),
        "dp_to_fit": rel(p_dp), "tp_to_fit": rel(p_tp),
        "tp_to_dp": rel(p_tp, p_dp),
        "control_quarter_batch": rel(p_quarter), "control_untrained":
        rel(p0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
