"""The data-parallel cell: BASELINE config 1 trained by the port's
`DataParallelTrainer` over `ranks` processes, one a card, joined by
`parallel.multihost.initialize` on a free local port, the gradients
all-reduced over NCCL every step.

Every rank builds the network from the configuration, lays the seed's
weights (made on its card by one `torch.rand`) into it, and makes the
same global batches from the seed (a generator a batch, so a batch does
not depend on how many are made); the trainer's device feed hands each
rank its rows. Set-up drives the trainer's own `fit` through the first
`checked_steps` global batches, one `fit` a batch, reading the loss a
step (a listener), the first gradient from AdaGrad's history after step
1 (its square root), and the parameters' change from the seeded start
after the last. The window then calls `fit` on the pool's batches, an
epoch a call, until rank 0's clock passes the window's end (rank 0
decides and tells the others over the job's host group before each
call); it ends with a `synchronize()` and a barrier, and rank 0's clock
gives the rate. After the ranks have exited, the float32 reference
(TF32 off) runs the checked steps on the whole global batches in this
process.
"""

from __future__ import annotations

import gc
import sys
import time

from harness import common, ranks

#: seconds the ranks have, from their start to their result
RANK_TIMEOUT_S = 300.0
#: what the name of each of NCCL's kernels holds
NCCL = "nccl"

# torch is imported inside the functions: `prelaunch` starts the ranks
# before the parent pays for its own `import torch`


def build_net(cfg: dict, device):
    from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    sizes = cfg["layer_sizes"]
    conf = (NeuralNetConfiguration.builder()
            .lr(cfg["lr"]).momentum(cfg["momentum"]).use_adagrad(True)
            .n_in(sizes[0]).activation_function(cfg["activation_function"])
            .weight_init(cfg["weight_init"])
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).batch_size(cfg["rows_per_rank"])
            .compute_dtype(cfg["compute_dtype"])
            .list(len(sizes) - 1).hidden_layer_sizes(list(sizes[1:-1]))
            .override(len(sizes) - 2, layer="output",
                      loss_function=cfg["loss_function"],
                      activation_function=cfg["output_activation"],
                      n_out=sizes[-1])
            .pretrain(False).build())
    return MultiLayerNetwork(conf, device=device)


def batch(cfg: dict, mix: dict, seed: int, index: int, device):
    """Global batch `index` of the seed: MNIST-shaped features (uniform
    in [0, 1), each zero with probability `zero_share`) and one-hot
    labels, made on `device`."""
    import torch

    rows = int(cfg["batch_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + 7919 * (index + 1)) % (1 << 63))
    n_in, n_out = cfg["layer_sizes"][0], cfg["layer_sizes"][-1]
    x = torch.rand((rows, n_in), generator=gen, device=device)
    keep = torch.rand((rows, n_in), generator=gen, device=device)
    x = x * (keep >= float(mix["zero_share"]))
    y = torch.nn.functional.one_hot(
        torch.randint(0, n_out, (rows,), generator=gen, device=device),
        n_out).float()
    return x, y


def host_batches(cfg, mix, seed, first, count, device):
    """`count` global batches from `first`, stacked on the host."""
    import torch

    xs, ys = zip(*(batch(cfg, mix, seed, first + i, device)
                   for i in range(count)))
    return torch.cat(xs).cpu().numpy(), torch.cat(ys).cpu().numpy()


def _norms(tensors) -> list:
    return [float(t.detach().float().norm()) for t in tensors]


def rank_main(rank: int, cfg: dict, mix: dict, seed: int, seconds: float,
              trace_on: bool, t_start: float) -> dict:
    import faulthandler

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import \
        CollectScoresListener
    from deeplearning4j_tpu_torch.parallel import (DataParallelTrainer,
                                                   make_mesh)
    from harness import weights

    n = dist.get_world_size()
    device = torch.device("cuda", rank) if torch.cuda.is_available() \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        # a spawned rank that hangs prints its stacks and ends before the
        # run's limit (a forked one, the tests', would inherit the
        # parent's watchdog state)
        faulthandler.dump_traceback_later(320, exit=True,
                                          file=sys.__stderr__)
    parts = {"spawn_and_join_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    mesh = make_mesh({"data": n}, device=device)
    # the data axis's communicator is built at its first collective:
    # here, once, rather than inside the checked steps
    dist.all_reduce(torch.zeros(1, device=device), group=mesh.group("data"))
    common.sync(device)
    parts["communicator_s"] = time.perf_counter() - t
    t = time.perf_counter()
    net = build_net(cfg, device)
    net.param_table = weights.mlp_params(cfg["layer_sizes"], seed, device)
    trainer = DataParallelTrainer(net, mesh)
    rows = int(cfg["batch_size"])
    n_check, n_pool = int(mix["checked_steps"]), int(mix["pool_batches"])
    x, y = host_batches(cfg, mix, seed, 0, n_check + n_pool, device)
    common.sync(device)
    parts["model_and_data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    scores = CollectScoresListener()
    net.set_listeners([scores])
    grad1 = None
    for s in range(n_check):
        trainer.fit(ListDataSetIterator(
            DataSet(x[s * rows:(s + 1) * rows], y[s * rows:(s + 1) * rows]),
            rows))
        if s == 0:
            grad1 = _norms(h.sqrt() for st in net._updater_state.values()
                           for h in st.hist.values())
    start = weights.mlp_params(cfg["layer_sizes"], seed, device)
    change = _norms(net.param_table[k][m] - start[k][m]
                    for k in net.param_table for m in net.param_table[k])
    prog = {"loss": [s for _, s in scores.scores], "grad": grad1,
            "change": change}
    net.set_listeners([])
    pool = ListDataSetIterator(DataSet(x[n_check * rows:],
                                       y[n_check * rows:]), rows)
    trace = common.DeviceTrace(device) if trace_on else None
    if trace is not None:
        trace.prepare()
    parts["checked_steps_s"] = time.perf_counter() - t
    flag = torch.zeros(2, dtype=torch.int32)
    steps = traced = 0
    trace_s = float(mix.get("trace_s", 2.0))
    gc.collect()
    common.sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    t1 = t0 + seconds
    while True:
        if rank == 0:
            now = time.perf_counter()
            flag[0] = int(now < t1)
            flag[1] = int(trace_on and now >= t1 - trace_s)
        dist.broadcast(flag, 0)
        if not flag[0]:
            break
        if flag[1] and not trace.active:
            trace.start()
        trainer.fit(pool)
        steps += n_pool
        if trace is not None and trace.active:
            traced += n_pool
    common.sync(device)
    dist.barrier()
    window_s = time.perf_counter() - t0
    out = {"rank": rank, "t0": t0, "window_s": window_s, "steps": steps,
           "parts": parts, "program": prog if rank == 0 else None,
           "peak": (torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0)}
    if trace is not None:
        if trace.active:
            trace.stop()
        out["trace"] = {"busy_s": trace.busy_s(),
                        "busy_layers_s": trace.busy_s(exclude=(NCCL,)),
                        "window_s": trace.window_s,
                        "nccl_each_s": trace.kernel_durations(NCCL),
                        "traced_steps": traced,
                        "breakdown": trace.breakdown() if rank == 0
                        else None}
    if device.type == "cuda":
        faulthandler.cancel_dump_traceback_later()
    return out


def reference_readings(cfg, mix, seed, device, precision="float32",
                       keep_rows=None, grad_scale: float = 1.0) -> dict:
    """The reference's losses, first-gradient norms and change norms
    over the checked steps (float32, or the control's precision, or a
    planted fault)."""
    from harness import weights
    from reference import fp8
    from reference import mlp as ref

    fp8.strict_float32()
    p = weights.mlp_params(cfg["layer_sizes"], seed, device)
    leaves = [p[k][m] for k in p for m in p[k]]
    start = [t.clone() for t in leaves]
    opt = ref.AdaGrad(leaves, cfg["lr"], cfg["momentum"])
    losses, g1 = [], None
    rows = int(cfg["batch_size"])
    for s in range(int(mix["checked_steps"])):
        x, y = batch(cfg, mix, seed, s, device)
        loss, grads = ref.loss_and_grads(p, x, y, precision, keep_rows,
                                         grad_scale)
        losses.append(loss)
        if g1 is None:
            g1 = _norms(grads)
        count = rows if keep_rows is None or grad_scale != 1.0 \
            else len(keep_rows)
        opt.step(leaves, grads, count)
    return {"loss": losses, "grad": g1,
            "change": _norms(a - b for a, b in zip(leaves, start))}


def prelaunch(spec, args, t_start: float, start: str = "spawn"):
    """Start the ranks (they import torch and join the job while the
    caller goes on); `run` gathers them."""
    cfg, mix = spec.config, spec.traffic
    return ranks.start_ranks(
        rank_main, int(cfg["ranks"]), cfg, mix, args.seed, args.seconds,
        bool(args.trace), t_start,
        timeout=RANK_TIMEOUT_S, start=start)


def run(spec, args, device, t_start: float) -> dict:
    import torch

    from harness import checks

    cfg, mix = spec.config, spec.traffic
    n = int(cfg["ranks"])
    on_cpu = device.type != "cuda"
    group = getattr(args, "prelaunched", None) or prelaunch(
        spec, args, t_start, "fork" if on_cpu else "spawn")
    results = group.wait()
    r0 = results[0]
    parts = dict(r0["parts"])
    setup_s = r0["t0"] - t_start
    ref_device = device if on_cpu else torch.device("cuda", 0)
    refr = reference_readings(cfg, mix, args.seed, ref_device)
    prog = r0["program"]
    names = [f"{k}/{m}" for k in ("0", "1", "2")[:len(cfg["layer_sizes"])
                                                 - 1] for m in ("W", "b")]
    checks.describe(names, prog, refr, sys.stderr)
    rows = int(cfg["batch_size"])
    e2e = {"train_samples_per_s": r0["steps"] * rows / r0["window_s"],
           "setup_s": setup_s}
    ctx = {"window_s": r0["window_s"], "steps": r0["steps"], "rows": rows,
           "chips": n, "sizes": cfg["layer_sizes"],
           "dtype": cfg["compute_dtype"],
           "rank_traces": [r.get("trace") for r in results]}
    trace = None
    if args.trace:
        tr = [r["trace"] for r in results]
        steps = max(1, tr[0]["traced_steps"])
        print("dp: NCCL kernels a traced step by rank "
              f"{[len(t['nccl_each_s']) / steps for t in tr]}, ms "
              f"{[1e3 * sum(t['nccl_each_s']) / steps for t in tr]}; busy "
              f"without them s {[t['busy_layers_s'] for t in tr]}",
              file=sys.stderr)
        trace = {"busy_s": sum(t["busy_s"] for t in tr) / len(tr),
                 "window_s": r0["trace"]["window_s"],
                 "breakdown": r0["trace"]["breakdown"]}
        ctx["trace_summary"] = trace
    gc.collect()
    return {"e2e": e2e, "ctx": ctx,
            "checks": checks.compare(prog, refr, spec.limits),
            "attempted": r0["steps"] + int(mix["checked_steps"]),
            "failed": 0, "peak": max(r["peak"] for r in results),
            "setup_parts": parts, "trace": trace}


def controls(spec, seeds, device) -> None:
    """The control (float8 products) and the planted faults, each
    against the float32 reference, a JSON line a seed."""
    import json

    from harness import checks

    cfg, mix = spec.config, spec.traffic
    rows, n = int(cfg["batch_size"]), int(cfg["ranks"])
    variants = {
        "control_fp8": {"precision": "fp8"},
        "half_batch": {"keep_rows": list(range(rows // 2))},
        # rank 0's rows alone, at its share of the global mean
        "no_exchange": {"keep_rows": list(range(rows // n)),
                        "grad_scale": 1.0 / n},
    }
    for seed in seeds:
        refr = reference_readings(cfg, mix, seed, device)
        moving = checks.moving_leaves(refr["grad"])
        line = {"workload": spec.name, "seed": seed}
        for name, kw in variants.items():
            r = reference_readings(cfg, mix, seed, device, **kw)
            line[name] = {
                "loss_gap": checks.loss_gap(r["loss"], refr["loss"]),
                "first_grad_gap": checks.norm_gap(r["grad"], refr["grad"]),
                "change_gap": checks.norm_gap(r["change"], refr["change"],
                                              moving)}
        print(json.dumps(line), flush=True)
        gc.collect()
