"""CLI of the port: train / test / predict / eval / checkpoint, the
counterpart of the JAX package's `cli.py`.

Parity: reference deeplearning4j-cli — args4j subcommands `Train`/`Test`/
`Predict` with --input/--model/--output flags (cli/subcommands/Train.java:31
— whose `exec()` is an EMPTY STUB :46; this implementation does what it
advertised) and the URI-scheme input dispatch of cli/api/flags/Input.java
(here: .csv vs .ckpt vs .npz by extension).

Usage (CLI = `python -m deeplearning4j_tpu_torch.cli`):
    CLI train   -i data.csv -m conf.json -o model.ckpt
    CLI train   ... --batch-size 50 --checkpoint-dir ckpts/
    CLI train   ... --batch-size 50 --checkpoint-dir ckpts/ --resume auto
    CLI test    -i data.csv -m model.ckpt
    CLI predict -i data.csv -m model.ckpt -o preds.csv
    CLI eval    -m ckpts/ --data heldout.csv --json
    CLI checkpoint inspect ckpts/
    CLI serve   -m model.ckpt --transformer '{"vocab_size": 64}' --port 0
    CLI fleet   -m model.ckpt --replicas 2 --device cpu \
                --serve-arg=--transformer --serve-arg='{"vocab_size": 64}'
    CLI batch   --url http://127.0.0.1:PORT -i prompts.jsonl -o out.jsonl
    CLI pipeline --checkpoint-dir ckpts/ --spawn-fleet -m model.ckpt \
                 --eval-data heldout.csv --state-dir state/ --cycles 10
    CLI train   -i data.csv -m conf.json -o model.ckpt --elastic 2 \
                --batch-size 50 --checkpoint-dir ckpts/ --device cpu
    CLI watchdog --max-restarts 3 -- train --elastic 2 ... --state-dir S

`-m` accepts a conf .json (fresh net), a single-file .ckpt, or a sharded
checkpoint DIRECTORY for train/test/predict/eval. Checkpoints cross
between this CLI and the JAX package's both ways.

Device: `train` (`--elastic` too), `test`, `predict`, `eval`, `serve`,
`fleet` and `pipeline` take `--device cuda|cpu` (default cuda, the
counterpart of pointing the JAX CLI at a platform). With `cuda` and no
CUDA device the command prints "no CUDA device" and exits 2; it never
carries on on the CPU. `fleet` runs
its router on the host and passes `--device` to every replica it spawns
(an operator's `--serve-arg=--device` still wins, as the later argparse
occurrence); a replica that cannot reach its device exits before it
announces and the spawn raises with its output tail. `checkpoint
inspect` reads manifests only and needs no device; `batch` is an HTTP
client.

`serve` prints one JSON announce line with the JAX CLI's keys
("serving", "role", "decode", "metrics", ...); `--smoke` starts, announces
and shuts down. `--transformer SPEC` (a JSON object of TransformerConfig
fields plus "seed"; "dtype" as "float32" or "bfloat16") initialises the
LM with the port's own initialiser, which is a pure function of (seed,
config): every process given the same SPEC holds the same weights, but
not the JAX CLI's (carry weights across with `weights.params_from_jax`).

`pipeline` runs the deployment controller (deploy/controller.py): it
watches `--checkpoint-dir`, gates each committed step on `--eval-data`
on `--device`, and promotes it through a fleet (`--fleet-url`, or
`--spawn-fleet`, which passes `--device` to every replica it spawns).
`train`, `serve`, `fleet` and `pipeline` take `--metrics-port` (a
standalone /metrics endpoint, announced up front) and `--trace PATH` (a
Chrome trace of the host spans, written on exit).

`train --elastic N` runs the elastic supervisor (scaleout/supervisor.py)
over N spawned `python -m deeplearning4j_tpu_torch.scaleout.worker`
processes and passes `--device` into the performer's conf, so every
worker, respawns included, trains on that device; the supervisor
process itself uses the device only for the final score. `watchdog --
<subcommand ...>` restarts a wrapped port subcommand under backoff while
it exits non-zero; with `--state-dir` on the wrapped `train --elastic`
each restart re-adopts the surviving workers.

The parser takes every subcommand and flag of the JAX CLI, so an argv
written for it parses, and every one of them is ported. `--compile-cache
DIR|auto|off` on train, serve, fleet and pipeline activates the program
store (`compilecache/`) before anything is built — the kernel library
then comes out of the store instead of `nvcc` where an earlier process
put it there, and spawned replicas and workers inherit the store through
`DL4J_TPU_COMPILE_CACHE`; serve's `--warmup-plan auto|PATH|off` replays
the recorded program set before `/readyz` flips. serve's announce line
carries `compile_cache` and `warmup_plan`.

Input CSV: one row per example, features then (for train/test) one-hot or
integer label in the last column(s) — controlled by --label-columns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

def _load_csv(path: str, label_columns: int,
              n_classes: Optional[int] = None
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    data = np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
    if label_columns <= 0:
        return data, None
    x = data[:, :-label_columns]
    y = data[:, -label_columns:]
    if label_columns == 1:  # integer class column -> one-hot
        labels = y.astype(int).ravel()
        # class count comes from the MODEL (n_out), not the data — a file
        # missing the top class must not shrink the label width
        classes = n_classes if n_classes else int(labels.max()) + 1
        if labels.max() >= classes:
            raise ValueError(
                f"label {labels.max()} out of range for model with "
                f"{classes} output classes")
        y = np.eye(classes, dtype=np.float32)[labels]
    return x, y


def _device(args) -> Optional[torch.device]:
    """The device `--device` names, or None after printing why there is
    none (the caller exits 2)."""
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return None
    return torch.device("cuda", torch.cuda.current_device())


def _load_model(path: str, device):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.scaleout.checkpoint import load_checkpoint

    if path.endswith(".json") and not os.path.isdir(path):
        with open(path) as f:  # fresh net from conf JSON
            return MultiLayerNetwork.from_config_json(f.read(),
                                                      device=device)
    # load_checkpoint dispatches: npz file OR sharded checkpoint dir
    net, _ = load_checkpoint(path, device=device)
    return net


def _model_n_out(net) -> Optional[int]:
    try:
        return net.conf.confs[-1].n_out or None
    except (AttributeError, IndexError):
        return None


def _activate_compile_cache(spec: Optional[str],
                            anchor: Optional[str]) -> Optional[str]:
    """`--compile-cache DIR|auto|off`: open the program store BEFORE any
    engine, trainer or kernel library is built. `auto` co-locates the
    store with `anchor` (the checkpoint/model dir) when one exists; with
    no flag at all the process still inherits `DL4J_TPU_COMPILE_CACHE`
    from a spawning parent lazily. Returns the active store directory
    (for the announce line) or None."""
    from deeplearning4j_tpu_torch import compilecache

    if spec and spec != "off":
        if spec == "auto":
            if not anchor or not os.path.isdir(anchor):
                return compilecache.active_dir()
            spec = compilecache.default_dir_for_checkpoints(anchor)
        compilecache.activate(spec)
    return compilecache.active_dir()


class _Telemetry:
    """Shared --metrics-port / --trace plumbing for train, serve, fleet
    and pipeline: an optional standalone /metrics endpoint for the run's
    lifetime, and a Chrome-trace dump (telemetry/trace.py, host spans
    only; the torch.profiler bridge stays off) on exit."""

    def __init__(self, args):
        self.metrics = None
        self.trace_path = getattr(args, "trace", None)
        port = getattr(args, "metrics_port", None)
        if port is not None:
            from deeplearning4j_tpu_torch.telemetry.exposition import \
                start_metrics_server

            self.metrics = start_metrics_server(port=port)
        if self.trace_path:
            from deeplearning4j_tpu_torch.telemetry import start_tracing

            start_tracing()

    def announce(self) -> dict:
        return ({"metrics": self.metrics.url + "/metrics"}
                if self.metrics is not None else {})

    def close(self) -> dict:
        out = {}
        if self.trace_path:
            from deeplearning4j_tpu_torch.telemetry import \
                save_chrome_trace

            if save_chrome_trace(self.trace_path):
                out["trace"] = self.trace_path
        if self.metrics is not None:
            self.metrics.close()
        return out


def cmd_train(args) -> int:
    from deeplearning4j_tpu_torch.scaleout.checkpoint import \
        DefaultModelSaver

    # before any step is built AND before the elastic supervisor builds
    # its WorkerSpawner (which exports the store to every worker)
    if args.checkpoint_dir and getattr(args, "compile_cache", None) \
            == "auto":
        os.makedirs(args.checkpoint_dir, exist_ok=True)
    _activate_compile_cache(getattr(args, "compile_cache", None),
                            args.checkpoint_dir)
    if args.elastic:
        return _cmd_train_elastic(args)
    if args.checkpoint_every is not None and not args.checkpoint_dir:
        # refusing beats a run the user believes is checkpointed
        print("--checkpoint-every needs --checkpoint-dir DIR "
              "(where the autosaves go)", file=sys.stderr)
        return 2
    device = _device(args)
    if device is None:
        return 2
    tele = _Telemetry(args)
    if tele.metrics is not None:
        # announce BEFORE the fit: the auto-assigned port is useless if
        # it first appears after the endpoint is already shut down
        print(json.dumps(tele.announce()), flush=True)
    try:
        resume_info = None
        if args.resume:
            net, resume_info = _resume_network(args, device)
            if net is None:
                return 2
        else:
            net = _load_model(args.model, device)
        x, y = _load_csv(args.input, args.label_columns, _model_n_out(net))
        if y is None:
            print("train requires labels (--label-columns >= 1)",
                  file=sys.stderr)
            return 2
        saver = None
        if args.checkpoint_dir:
            # sharded async autosaves off the hot path
            from deeplearning4j_tpu_torch.checkpoint import \
                ShardedModelSaver

            saver = ShardedModelSaver(args.checkpoint_dir,
                                      keep=args.checkpoint_keep)
        try:
            every = (args.checkpoint_every or 1
                     if saver is not None else None)
            if resume_info is not None:
                _fit_resumed(net, x, y, args, saver, resume_info)
            elif args.batch_size:
                # iterator path: the checkpoint cursor counts these
                # mini-batches, which is what --resume fast-forwards to
                from deeplearning4j_tpu_torch.datasets import (
                    DataSet, ListDataSetIterator)

                net.fit(ListDataSetIterator(DataSet(x, y), args.batch_size),
                        epochs=args.epochs, saver=saver,
                        checkpoint_every=every)
            else:
                net.fit(x, y, epochs=args.epochs, saver=saver,
                        checkpoint_every=every)
        finally:
            if saver is not None:
                saver.close()  # every pending autosave is durable
        DefaultModelSaver(args.output).save(net)
        score = float(net.score(x, y))
    finally:
        # a failing fit (divergence abort, preemption) is exactly the
        # run whose trace is wanted: flush it on the way out too
        closed = tele.close()
    # announce() is NOT repeated here: the metrics endpoint is already
    # closed, and a dead URL in the summary line would mislead parsers
    summary = {"saved": args.output, "score": score, **closed}
    if resume_info is not None:
        summary["resumed_from"] = resume_info["step"]
    print(json.dumps(summary))
    return 0


def _cmd_train_elastic(args) -> int:
    """`train --elastic N`: the self-healing out-of-process path — a
    TrainingSupervisor over N spawned workers with failure detection,
    bounded respawn, straggler defense, and checkpoint-backed elastic
    resume (docs/FAULT_TOLERANCE.md). `--device` goes into the
    performer's conf: every worker trains there."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets.api import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.scaleout.api import CollectionJobIterator
    from deeplearning4j_tpu_torch.scaleout.checkpoint import \
        DefaultModelSaver
    from deeplearning4j_tpu_torch.scaleout.registry import ConfigRegistry
    from deeplearning4j_tpu_torch.scaleout.supervisor import (
        TrainingSupervisor, WorkerSpawner)

    if args.resume == "auto" and not args.checkpoint_dir:
        # same refusal as the non-elastic path: silently starting a
        # fresh run would discard progress the user asked to keep
        print("--resume auto needs --checkpoint-dir DIR to discover "
              "the latest committed step from", file=sys.stderr)
        return 2
    device = _device(args)
    if device is None:
        return 2
    tele = _Telemetry(args)
    if tele.metrics is not None:
        # announce BEFORE the run (cmd_train's contract): an
        # auto-assigned metrics port is useless once the run is over
        print(json.dumps(tele.announce()), flush=True)
    try:
        net = _load_model(args.model, device)
        conf_json = net.to_json()
        x, y = _load_csv(args.input, args.label_columns, _model_n_out(net))
        if y is None:
            print("train requires labels (--label-columns >= 1)",
                  file=sys.stderr)
            return 2
        bs = args.batch_size or getattr(net.conf, "batch_size", None) or 32
        batches = [DataSet(x[i:i + bs], y[i:i + bs])
                   for i in range(0, len(x), bs)]
        jobs = [b for _ in range(args.epochs) for b in batches]
        state_dir = getattr(args, "state_dir", None)
        work = (state_dir or args.checkpoint_dir
                or tempfile.mkdtemp(prefix="dl4j_elastic_"))
        registry_root = os.path.join(work, "_registry")
        # with a state dir the run name must be STABLE across control-
        # plane incarnations: surviving workers rendezvous on it to
        # reconnect, and the restarted supervisor re-registers it. A
        # pid-scoped name is only safe when nothing outlives this
        # process.
        run_name = ("cli-elastic" if state_dir
                    else f"cli-elastic-{os.getpid()}")
        sup = TrainingSupervisor(
            CollectionJobIterator(jobs), run_name=run_name,
            registry=ConfigRegistry(registry_root),
            performer_class=("deeplearning4j_tpu_torch.scaleout.perform."
                             "NeuralNetWorkPerformer"),
            performer_conf={"conf_json": conf_json, "epochs": 1,
                            "device": args.device},
            n_workers=args.elastic, conf_json=conf_json,
            spawner=WorkerSpawner(registry_root, run_name),
            checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
            max_respawns=args.max_respawns,
            straggler_factor=args.straggler_factor,
            keep_checkpoints=args.checkpoint_keep,
            status_port=args.status_port,
            state_dir=state_dir)
        if sup.status_server is not None:
            print(json.dumps({"status": sup.status_server.address,
                              "workers": args.elastic}), flush=True)
        final = sup.run(timeout=args.run_timeout)
        trained = MultiLayerNetwork.from_config_json(
            conf_json, params=np.asarray(final), device=device)
        DefaultModelSaver(args.output).save(trained)
        score = float(trained.score(x, y))
        print(json.dumps({
            "saved": args.output, "score": score,
            "workers": args.elastic, "waves": sup.waves,
            "jobs": len(jobs), "folded": len(sup.folded_seqs),
            "respawns": sup.respawns_used,
            "evictions": {k: int(c.value)
                          for k, c in sup._m_evictions.items()
                          if c.value},
            "resumes": len(sup.resume_events),
            "incarnation": sup.incarnation,
            "adopted": sum(1 for e in sup.adoption_events
                           if e["kind"] in ("adopted", "stray")),
            **tele.close()}))
        return 0
    except BaseException:
        tele.close()
        raise


def _resume_network(args, device):
    """`--resume auto` (or an explicit path): restore params + updater
    state + cursor from the newest COMMITTED step — no step dir named.
    `auto` on an EMPTY checkpoint dir starts fresh (the restart-wrapper
    semantic); a dir holding only torn saves still errors, listing the
    candidate step dirs. Returns (net, info), (net, None) for a fresh
    `auto` start, or (None, None) after printing the error."""
    from deeplearning4j_tpu_torch.checkpoint.format import CheckpointError
    from deeplearning4j_tpu_torch.checkpoint.restore import (
        discover_latest, restore_network)

    source = args.checkpoint_dir if args.resume == "auto" else args.resume
    if not source:
        print("--resume auto needs --checkpoint-dir DIR to discover "
              "the latest committed step from", file=sys.stderr)
        return None, None
    try:
        root, step = discover_latest(source)
        net, info = restore_network(root, step, device=device)
    except (CheckpointError, FileNotFoundError) as e:
        if args.resume == "auto" and "no sharded checkpoint steps" \
                in str(e):
            # nothing saved yet: auto means "resume IF any" — a restart
            # wrapper's first launch starts fresh
            print(json.dumps({"resuming": None,
                              "note": "no committed checkpoint yet; "
                                      "starting fresh"}), flush=True)
            return _load_model(args.model, device), None
        print(f"cannot resume: {e}", file=sys.stderr)
        return None, None
    print(json.dumps({"resuming": root, "step": step,
                      "iterator_position": info.get("iterator_position"),
                      "epoch": info.get("metadata", {}).get("epoch")}),
          flush=True)
    return net, info


def _fit_resumed(net, x, y, args, saver, info) -> None:
    """Continue a restored run: fast-forward the data stream to the
    checkpoint's within-epoch cursor and seed the guard's position so
    new autosaves extend — never collide with — the committed steps."""
    from deeplearning4j_tpu_torch.datasets import (DataSet, DeviceFeed,
                                                   ListDataSetIterator)

    position = int(info.get("iterator_position") or 0)
    meta = info.get("metadata", {}) or {}
    epoch = int(meta.get("epoch") or 0)
    epoch_batch = int(meta.get("epoch_batch") or 0)
    bs = args.batch_size or len(x)
    feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), bs),
                      device=net.device)
    feed.fast_forward(epoch_batch)
    remaining = max(1, args.epochs - epoch)
    net.fit(feed, epochs=remaining, saver=saver,
            checkpoint_every=(args.checkpoint_every or 1
                              if saver is not None else None),
            start_position=position, start_epoch=epoch,
            start_epoch_batch=epoch_batch)


def cmd_watchdog(args) -> int:
    """`watchdog -- <subcommand ...>`: restart-under-backoff wrapper so
    the control plane itself is supervised (docs/FAULT_TOLERANCE.md
    "Who watches the watcher"). Runs `python -m
    deeplearning4j_tpu_torch.cli <subcommand ...>` and, while it exits
    non-zero (crash, OOM-kill, SIGKILL), restarts it with exponential
    backoff up to `--max-restarts` times. Paired with `--state-dir` on
    the wrapped `train --elastic` / `fleet`, each restart re-adopts the
    previous incarnation's journaled children instead of respawning
    them.

    The child is NOT placed in its own session and NOT registered for
    the orphan sweep: the watchdog dying must never take the control
    plane (or transitively the whole run) down with it."""
    import signal
    import subprocess
    import time as _time

    rest = list(args.cmd)
    if rest and rest[0] == "--":
        rest = rest[1:]
    if not rest:
        print("watchdog needs a wrapped subcommand: "
              "watchdog [opts] -- train --elastic ... --state-dir DIR",
              file=sys.stderr)
        return 2
    if rest[0] == "watchdog":
        print("watchdog cannot wrap itself", file=sys.stderr)
        return 2
    restarts = 0
    child = None

    def forward(signum, _frame):
        # operator stop is for the WHOLE plane: forward and stop
        # restarting (a forwarded SIGTERM exits the child non-zero,
        # which must not trigger a respawn)
        if child is not None and child.poll() is None:
            child.send_signal(signum)
        raise KeyboardInterrupt

    # both stop signals forward: a process manager signalling only the
    # watchdog pid (no process-group fan-out like terminal Ctrl-C) must
    # still reach the child so it can run its graceful handoff close
    old_term = signal.signal(signal.SIGTERM, forward)
    old_int = signal.signal(signal.SIGINT, forward)
    try:
        while True:
            # the KeyboardInterrupt guard spans the WHOLE iteration —
            # forward() raises from arbitrary main-thread points
            # (mid-Popen, mid-print, mid-backoff), and every one of
            # them must take the same stop-grace-then-kill exit, never
            # an uncaught traceback that leaves the child unreaped
            try:
                child = subprocess.Popen(
                    [sys.executable, "-m", "deeplearning4j_tpu_torch.cli"]
                    + rest)
                print(json.dumps({"watchdog_child": child.pid,
                                  "restarts": restarts}), flush=True)
                rc = child.wait()
                if rc == 0:
                    print(json.dumps({"watchdog_done": True,
                                      "restarts": restarts}),
                          flush=True)
                    return 0
                if restarts >= args.max_restarts:
                    print(json.dumps({"watchdog_gave_up": True,
                                      "rc": rc,
                                      "restarts": restarts}),
                          flush=True)
                    return rc if rc > 0 else 1
                backoff = min(args.backoff * (2 ** restarts),
                              args.backoff_max)
                restarts += 1
                print(json.dumps({"watchdog_restart": restarts,
                                  "rc": rc,
                                  "backoff_s": round(backoff, 3)}),
                      flush=True)
                _time.sleep(backoff)
            except KeyboardInterrupt:
                if child is not None and child.poll() is None:
                    try:
                        child.wait(timeout=args.stop_grace)
                    except subprocess.TimeoutExpired:
                        child.kill()
                        child.wait()
                return 130
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)


def cmd_test(args) -> int:
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

    device = _device(args)
    if device is None:
        return 2
    net = _load_model(args.model, device)
    x, y = _load_csv(args.input, args.label_columns, _model_n_out(net))
    if y is None:
        print("test requires labels (--label-columns >= 1)", file=sys.stderr)
        return 2
    ev = Evaluation()
    ev.eval(y, net.output(x))
    print(ev.stats())
    print(json.dumps({"f1": ev.f1(), "accuracy": ev.accuracy(),
                      "precision": ev.precision(), "recall": ev.recall()}))
    return 0


def cmd_predict(args) -> int:
    device = _device(args)
    if device is None:
        return 2
    # default 0: predict input is normally features-only; pass
    # --label-columns 1 to reuse a labelled train/test CSV
    x, _ = _load_csv(args.input, args.label_columns)
    net = _load_model(args.model, device)
    n_in = net.conf.confs[0].n_in
    if n_in and x.shape[1] != n_in:
        print(f"input has {x.shape[1]} feature columns but the model "
              f"expects {n_in}; use --label-columns to drop trailing "
              f"label column(s)", file=sys.stderr)
        return 2
    preds = net.predict(x)
    if args.output:
        np.savetxt(args.output, preds, fmt="%d")
        print(json.dumps({"saved": args.output, "n": int(preds.shape[0])}))
    else:
        for p in preds:
            print(int(p))
    return 0


def cmd_checkpoint(args) -> int:
    """`checkpoint inspect <dir>`: print the sharded-checkpoint manifest
    — committed steps, source mesh/strategy, cursor, and the per-leaf
    layout (dtype/global shape/shards/bytes)."""
    from deeplearning4j_tpu_torch.checkpoint import (leaf_summary,
                                                     list_steps,
                                                     read_manifest,
                                                     tree_scalars)
    from deeplearning4j_tpu_torch.checkpoint.restore import resolve_root

    if args.action != "inspect":  # argparse choices already guard this
        print(f"unknown checkpoint action {args.action!r}", file=sys.stderr)
        return 2
    root, pinned = resolve_root(args.dir)  # root OR one step dir
    steps = list_steps(root)
    if not steps:
        print(f"no committed sharded checkpoint under {args.dir!r}",
              file=sys.stderr)
        return 2
    step = args.step if args.step is not None else pinned
    manifest = read_manifest(root, step)
    # scalars only — inspect must stay O(manifest), never read shards
    payload = tree_scalars(manifest)
    leaves = leaf_summary(manifest)
    out = {
        "dir": root,
        "steps": steps,
        "step": manifest["step"],
        "saved_at": manifest.get("saved_at"),
        "mesh": manifest.get("mesh"),
        "format_version": payload.get("format_version"),
        "iterator_position": payload.get("iterator_position"),
        "iteration_count": payload.get("iteration_count"),
        "metadata": {k: v for k, v in payload.get("metadata", {}).items()
                     if isinstance(v, (str, int, float, bool, type(None)))},
        "total_bytes": manifest.get("total_bytes"),
        "n_leaves": len(leaves),
    }
    if args.json:
        out["leaves"] = [{**row, "shape": list(row["shape"])}
                         for row in leaves]
        print(json.dumps(out))
        return 0
    print(json.dumps(out, indent=2))
    print(f"{'leaf':40s} {'dtype':10s} {'shape':18s} {'shards':>6s} "
          f"{'bytes':>12s}")
    for row in leaves:
        print(f"{row['leaf']:40s} {row['dtype']:10s} "
              f"{str(row['shape']):18s} {row['shards']:>6d} "
              f"{row['bytes']:>12d}")
    return 0


def cmd_eval(args) -> int:
    """`eval`: one-shot held-out evaluation of a checkpoint, printing
    the same metrics JSON shape as `test` plus the checkpoint's
    identity."""
    from deeplearning4j_tpu_torch.eval.holdout import evaluate_checkpoint

    device = _device(args)
    if device is None:
        return 2
    try:
        out = evaluate_checkpoint(args.model, args.data,
                                  label_columns=args.label_columns,
                                  step=args.step, device=device)
    except Exception as exc:  # noqa: BLE001 — CLI boundary
        print(f"eval failed: {exc}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(out))
    else:
        print(json.dumps(out, indent=2))
    return 0


def cmd_batch(args) -> int:
    """`batch`: bulk generation through a router (or single replica) on
    the BATCH SLO tier — the offline lane's reference client
    (docs/SERVING.md "Priority tiers").

    Reads a JSONL prompt file (each line a bare token list, or an
    object {"prompt": [...], "max_tokens": N}), drives chunks of
    --batch-size rows through ``POST /generate`` with
    ``"priority": "batch"`` (plus the X-Priority header so routers
    shed/forward without parsing the body), and appends one result
    line per row to --output. Progress is crash-safe: rows are fsynced
    to the output BEFORE the cursor journal (StateFile) commits, so a
    killed client restarts exactly where it stopped — uncommitted tail
    rows are truncated and re-run, committed rows are never re-emitted
    (each input row lands in the output exactly once). A 503 shed is
    waited out via the tier-aware ``retry_after_ms`` the shed reply
    carries; slot preemptions never surface here at all — the router's
    durable-stream resume replays them losslessly, and the reply's
    `preempt_resumes` count is accumulated into the summary."""
    import hashlib
    import time as _time
    import urllib.error
    import urllib.request

    from deeplearning4j_tpu_torch.serving.errors import (
        PRIORITY_HEADER, TIER_BATCH)
    from deeplearning4j_tpu_torch.utils.statefile import StateFile

    rows = []
    with open(args.input, "rb") as f:
        raw = f.read()
    for ln, line in enumerate(raw.decode().splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        if isinstance(obj, list):
            rows.append((obj, args.max_tokens))
        elif isinstance(obj, dict) and "prompt" in obj:
            rows.append((obj["prompt"],
                         int(obj.get("max_tokens", args.max_tokens))))
        else:
            print(f"{args.input}:{ln}: each line must be a token list "
                  "or an object with \"prompt\"", file=sys.stderr)
            return 2
    if not rows:
        print(f"{args.input}: no prompt rows", file=sys.stderr)
        return 2
    input_sha = hashlib.sha256(raw).hexdigest()

    journal_path = args.journal or (args.output + ".journal")
    journal = StateFile(journal_path)
    state = journal.read()
    cursor = 0
    sheds_total = 0
    preempts_total = 0
    if state is not None:
        if state.get("input_sha") != input_sha:
            print(f"journal {journal_path} was committed against a "
                  "DIFFERENT input file (sha mismatch); delete the "
                  "journal (and the output) to start over",
                  file=sys.stderr)
            return 2
        cursor = int(state.get("cursor", 0))
        sheds_total = int(state.get("sheds", 0))
        preempts_total = int(state.get("preempt_resumes", 0))
    resumed_at = cursor

    # reconcile the output against the committed cursor: rows past it
    # were appended but never committed (crash between the output
    # fsync and the journal write) — truncate so they re-run; fewer
    # rows than the cursor promises means the pair was tampered with,
    # and resuming would silently drop rows
    if os.path.exists(args.output):
        with open(args.output, "rb+") as out:
            data = out.read()
            ends = [i for i, b in enumerate(data) if b == 0x0A]
            if len(ends) < cursor:
                print(f"output {args.output} holds {len(ends)} rows "
                      f"but the journal committed {cursor}; refusing "
                      "to resume from an inconsistent pair",
                      file=sys.stderr)
                return 2
            out.truncate(ends[cursor - 1] + 1 if cursor else 0)
    elif cursor:
        print(f"journal committed {cursor} rows but output "
              f"{args.output} is missing; delete the journal to start "
              "over", file=sys.stderr)
        return 2

    url = args.url.rstrip("/")
    headers = {"Content-Type": "application/json",
               PRIORITY_HEADER: TIER_BATCH}
    start = _time.perf_counter()
    out_f = open(args.output, "ab")
    try:
        while cursor < len(rows):
            chunk = rows[cursor:cursor + args.batch_size]
            body = {"prompt": [r[0] for r in chunk],
                    "max_tokens": [r[1] for r in chunk],
                    "priority": TIER_BATCH}
            if args.eos_id is not None:
                body["eos_id"] = args.eos_id
            payload = json.dumps(body).encode()
            sheds = 0
            while True:
                req = urllib.request.Request(url + "/generate",
                                             data=payload,
                                             headers=headers)
                try:
                    with urllib.request.urlopen(
                            req, timeout=args.timeout) as r:
                        reply = json.loads(r.read())
                    break
                except urllib.error.HTTPError as e:
                    raw_err = e.read()
                    if e.code == 503 and sheds < args.max_shed_retries:
                        # the batch lane shed us (it sheds FIRST, at
                        # its own lower high-water mark): wait out the
                        # backlog-derived Retry-After and try again
                        sheds += 1
                        sheds_total += 1
                        try:
                            err = json.loads(raw_err)
                        except ValueError:
                            err = {}
                        wait = min(5.0, max(
                            0.05,
                            float(err.get("retry_after_ms", 1000))
                            / 1000.0))
                        _time.sleep(wait)
                        continue
                    print(f"batch: /generate answered {e.code}: "
                          f"{raw_err.decode(errors='replace')[:200]}",
                          file=sys.stderr)
                    return 3
            if "error" in reply:
                # a durable-stream router reports an exhausted resume
                # budget in-band, not as a raw 5xx
                print(f"batch: generation failed: {reply['error']}",
                      file=sys.stderr)
                return 3
            toks = reply["tokens"]
            reasons = (reply.get("finish_reasons")
                       or [None] * len(toks))
            preempts_total += int(reply.get("preempt_resumes", 0) or 0)
            for i in range(len(chunk)):
                out_f.write((json.dumps(
                    {"row": cursor + i,
                     "tokens": toks[i],
                     "finish_reason": reasons[i]}) + "\n").encode())
            # rows reach disk BEFORE the cursor commits: a crash
            # between the two re-runs the chunk (truncated on resume),
            # never skips or duplicates it
            out_f.flush()
            os.fsync(out_f.fileno())
            cursor += len(chunk)
            journal.write({"input": os.path.abspath(args.input),
                           "input_sha": input_sha,
                           "output": os.path.abspath(args.output),
                           "cursor": cursor,
                           "total": len(rows),
                           "sheds": sheds_total,
                           "preempt_resumes": preempts_total})
            if args.progress:
                print(json.dumps({"cursor": cursor,
                                  "total": len(rows),
                                  "sheds": sheds_total,
                                  "preempt_resumes": preempts_total}),
                      flush=True)
    finally:
        out_f.close()
    print(json.dumps({"batch_done": True,
                      "rows": len(rows),
                      "resumed_at": resumed_at,
                      "output": os.path.abspath(args.output),
                      "journal": journal_path,
                      "sheds": sheds_total,
                      "preempt_resumes": preempts_total,
                      "seconds": round(_time.perf_counter() - start,
                                       3)}), flush=True)
    return 0


def _transformer_from_spec(spec: str, device):
    """(params, cfg) from a transformer SPEC: a JSON object (inline or a
    file path) of TransformerConfig fields plus an optional "seed"
    ("dtype" as "float32" or "bfloat16"; the JAX-only "interpret" is
    ignored). Initialisation is a pure function of (seed, config), so
    every process given the same SPEC holds the same weights."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer_params)

    raw = spec
    if os.path.exists(spec):
        with open(spec) as f:
            raw = f.read()
    fields = json.loads(raw)
    if not isinstance(fields, dict):
        raise ValueError("transformer SPEC must be a JSON object")
    seed = int(fields.pop("seed", 0))
    fields.pop("interpret", None)
    if isinstance(fields.get("dtype"), str):
        fields["dtype"] = getattr(torch, fields["dtype"])
    cfg = TransformerConfig(**fields)
    return init_transformer_params(seed, cfg, device=device), cfg


def cmd_serve(args) -> int:
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    from deeplearning4j_tpu_torch.serving.server import serve_network

    device = _device(args)
    if device is None:
        return 2
    tele = _Telemetry(args)
    try:
        # activate BEFORE model/engine construction so every program the
        # serving stack builds goes through the store
        cache_dir = _activate_compile_cache(
            args.compile_cache,
            args.model if os.path.isdir(args.model) else None)
        net = _load_model(args.model, device)
        n_in = net.conf.confs[0].n_in
        # initial checkpoint identity for /readyz and /stats: what this
        # server was launched from (reloads overwrite it)
        ck = None
        if os.path.isdir(args.model):
            from deeplearning4j_tpu_torch.checkpoint.restore import \
                discover_latest
            try:
                _, ck_step = discover_latest(args.model)
            except Exception:
                ck_step = None
            ck = {"path": os.path.abspath(args.model), "step": ck_step}
        elif not args.model.endswith(".json"):
            ck = {"path": os.path.abspath(args.model), "step": None}
        gen = None
        if args.transformer:
            params, cfg = _transformer_from_spec(args.transformer, device)
            gen = InferenceEngine.for_transformer(params, cfg,
                                                  device=device)
        draft_params = draft_cfg = None
        if getattr(args, "draft_model", None):
            draft_params, draft_cfg = _transformer_from_spec(
                args.draft_model, device)
        kernel = "kernel" if args.decode_kernel == "pallas" \
            else args.decode_kernel
        handle = serve_network(
            net, checkpoint=ck, generate_engine=gen,
            host=args.host, port=args.port, n_replicas=args.replicas,
            max_batch_size=args.max_batch_size,
            max_delay_ms=args.max_delay_ms,
            max_queue=args.max_queue,
            batch_share=args.batch_share,
            slots=args.slots, page_size=args.page_size,
            kv_pages=args.kv_pages,
            prefix_cache=args.prefix_cache,
            fleet_kv=args.fleet_kv,
            kv_ship_timeout=args.kv_ship_timeout,
            decode_kernel=kernel,
            horizon=args.horizon,
            speculation=args.speculation,
            drafter=args.drafter,
            draft_params=draft_params, draft_cfg=draft_cfg,
            draft_window=args.draft_window,
            warmup_shape=(n_in,) if (args.warmup and n_in) else None,
            warmup_async=args.warmup_async,
            warmup_plan=args.warmup_plan,
            role=args.role, model_id=args.model_id)
    except BaseException:
        tele.close()
        raise
    # the announce line's "decode" object records the decode
    # configuration this process actually runs (the JAX CLI's keys)
    loop = gen.decode_loop if gen is not None else None
    print(json.dumps({"serving": handle.url,
                      "role": args.role,
                      "model_id": args.model_id,
                      "replicas": len(handle.replicas.engines),
                      "max_batch_size": args.max_batch_size,
                      "max_delay_ms": args.max_delay_ms,
                      "slots": args.slots,
                      "page_size": args.page_size,
                      "prefix_cache": args.prefix_cache,
                      "decode_kernel": args.decode_kernel,
                      "decode": {
                          "kernel": {
                              "requested": args.decode_kernel,
                              "selected": (loop.decode_kernel
                                           if loop is not None else None),
                          },
                          "prefix_cache": args.prefix_cache,
                          "fleet_kv": (loop.fleet_kv
                                       if loop is not None
                                       else args.fleet_kv),
                          "slots": args.slots,
                          "batch_share": args.batch_share,
                          "page_size": args.page_size,
                          "kv_pages": (loop.n_pages
                                       if loop is not None else None),
                          "horizon": args.horizon,
                          "speculation": {
                              "enabled": bool(args.speculation),
                              "k": args.speculation,
                              "drafter": (
                                  loop._drafter.kind
                                  if loop is not None
                                  and loop._drafter is not None
                                  else None),
                              "draft_window": (
                                  args.draft_window
                                  if args.drafter == "model"
                                  and args.speculation else None),
                          },
                      },
                      "compile_cache": cache_dir,
                      "warmup_plan": handle.warmup_plan_path,
                      "metrics": handle.url + "/metrics",
                      **tele.announce()}), flush=True)
    if args.smoke:  # start/stop sanity check (tests, deploy probes)
        handle.close()
        tele.close()
        return 0
    try:
        handle.http.thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        handle.close()
        tele.close()
    return 0


def _parse_roles(spec: str) -> dict:
    """`prefill=1,decode=2` -> {"prefill": 1, "decode": 2}."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, n = part.partition("=")
        name = name.strip()
        if name not in ("prefill", "decode", "unified"):
            raise ValueError(
                f"--roles: unknown role {name!r} (expected "
                "prefill/decode/unified)")
        out[name] = int(n or 1)
        if out[name] < 0:
            raise ValueError(f"--roles: {name} count must be >= 0")
    return out


def _parse_models(spec: str) -> dict:
    """`tiny=conf.json,big=ckpt/` -> {"tiny": "conf.json", ...}."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, path = part.partition("=")
        if not name.strip() or not path.strip():
            raise ValueError(
                f"--models: need NAME=PATH, got {part!r}")
        out[name.strip()] = path.strip()
    return out


def cmd_fleet(args) -> int:
    """`fleet`: spawn N local replica server processes (and/or attach
    running ones by URL) behind the router tier — health-based
    eviction/rejoin, least-loaded routing with retries, load shedding,
    rolling `POST /reload`, `POST /scale` (docs/FLEET.md). `--roles`
    and/or `--models` replace the flat --replicas spawn with
    per-(model, role) pools: each pool's replicas get the matching
    `--role`/`--model-id` serve flags and autoscale independently.
    Every spawned replica gets `--device` (before the operator's
    `--serve-arg`s, which win)."""
    from deeplearning4j_tpu_torch.serving.fleet import (Autoscaler, Fleet,
                                                        ReplicaSpawner)
    from deeplearning4j_tpu_torch.serving.router import (ReplicaClient,
                                                         serve_fleet)

    try:
        roles = _parse_roles(args.roles) if args.roles else {}
        models = _parse_models(args.models) if args.models else {}
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    pooled = bool(roles or models)
    if pooled and not models and not args.model:
        print("fleet --roles needs -m MODEL (or --models)",
              file=sys.stderr)
        return 2
    if not pooled and not args.attach \
            and (not args.model or args.replicas < 1):
        print("fleet needs -m MODEL with --replicas >= 1, --roles/"
              "--models, and/or --attach URL", file=sys.stderr)
        return 2
    autoscaler = None
    if args.autoscale and not pooled:
        lo, _, hi = args.autoscale.partition(":")
        autoscaler = Autoscaler(min_replicas=int(lo),
                                max_replicas=int(hi or lo))
    # activate before the spawner snapshots its child environment: every
    # replica (initial, autoscaled, respawned) inherits the store
    _activate_compile_cache(
        getattr(args, "compile_cache", None),
        args.model if args.model and os.path.isdir(args.model) else None)
    # the fleet's KV mode and device lead the spawned replicas' serve
    # args so an explicit --serve-arg from the operator still wins
    # (later argparse occurrence overrides)
    lead = ["--fleet-kv", args.fleet_kv, "--device", args.device]
    spawner = None
    if not pooled and args.model \
            and (args.replicas > 0 or autoscaler is not None):
        spawner = ReplicaSpawner(args.model,
                                 serve_args=lead + args.serve_arg)
    tele = _Telemetry(args)
    fleet = Fleet(spawner=spawner,
                  heartbeat_interval=args.heartbeat_interval,
                  heartbeat_timeout=args.heartbeat_timeout,
                  shed_high_water=args.shed_high_water,
                  batch_high_water=args.batch_high_water,
                  request_timeout=args.request_timeout,
                  retry_budget=args.retry_budget,
                  stream_resume_attempts=args.stream_resume_attempts,
                  breaker_threshold=args.breaker_threshold,
                  breaker_reset_s=args.breaker_reset,
                  autoscaler=autoscaler,
                  state_dir=args.state_dir,
                  initial_checkpoint=(args.model
                                      if args.model
                                      and not args.model.endswith(".json")
                                      else None))
    # a crash-restarted router re-adopted its journaled replicas in the
    # Fleet constructor: only spawn the CAPACITY GAP, never a duplicate
    # world next to the warm one
    handoff_exit = bool(args.state_dir) and not args.smoke
    handle = None
    try:
        attached = {r["url"] for r in
                    fleet.snapshot()["replicas"].values()}
        for url in args.attach:
            if ReplicaClient(url).url not in attached:
                fleet.attach(url)
        if pooled:
            # per-(model, role) pools: each gets its own spawner whose
            # serve_args bake in the matching --role/--model-id, its
            # own autoscaler bounds, and spawns only the gap the
            # re-adopted warm world leaves (matched by announced
            # identity — journal adoption works per pool too)
            model_pools = models or {"default": args.model}
            role_layout = roles or {"unified": args.replicas}
            reps = fleet.snapshot()["replicas"]
            for mname, mpath in model_pools.items():
                for rname, want in role_layout.items():
                    sargs = list(lead)
                    if rname != "unified":
                        sargs += ["--role", rname]
                    if models:
                        sargs += ["--model-id", mname]
                    sargs += args.serve_arg
                    pool_scaler = None
                    if args.autoscale:
                        lo, _, hi = args.autoscale.partition(":")
                        pool_scaler = Autoscaler(
                            min_replicas=int(lo),
                            max_replicas=int(hi or lo))
                    fleet.add_pool(
                        model_id=mname, role=rname,
                        spawner=ReplicaSpawner(mpath,
                                               serve_args=sargs),
                        autoscaler=pool_scaler)
                    have = sum(
                        1 for r in reps.values()
                        if r["state"] != "evicted"
                        and (r.get("role") or "unified") == rname
                        and (r.get("model_id") or "default") == mname)
                    if want > have:
                        fleet.spawn_pool(mname, rname, want - have)
        elif spawner is not None and args.replicas > 0:
            # --replicas counts LOCAL processes: only spawned members
            # (the adopted warm world) fill the quota — attached URLs
            # are additive, exactly as on a fresh start
            have = sum(1 for r in fleet.snapshot()["replicas"].values()
                       if r["spawned"] and r["state"] != "evicted")
            if args.replicas > have:
                fleet.spawn(args.replicas - have)
        handle = serve_fleet(fleet, host=args.host, port=args.port,
                             fleet_kv=args.fleet_kv)
        fleet.wait_ready(1, timeout=args.ready_timeout)
    except BaseException:
        if handle is not None:
            handle.close(stop_replicas=not handoff_exit,
                         handoff=handoff_exit)
        else:
            fleet.close(stop_replicas=not handoff_exit,
                        handoff=handoff_exit)
        tele.close()
        raise
    # snapshot() reads membership under the fleet lock — the monitor
    # thread may be autoscale-spawning concurrently
    print(json.dumps({"router": handle.url,
                      "replicas": fleet.state_counts(),
                      "roles": fleet.role_counts(),
                      "incarnation": fleet.incarnation,
                      "adopted": sum(1 for e in fleet.adoption_events
                                     if e["kind"] in ("adopted",
                                                      "attached")),
                      "endpoints": [rep["url"] for rep in
                                    fleet.snapshot()["replicas"]
                                    .values()],
                      "metrics": handle.url + "/metrics",
                      **tele.announce()}), flush=True)
    if args.smoke:
        handle.close(stop_replicas=True)
        tele.close()
        return 0
    try:
        handle.http.thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        # with a state dir, an exiting router HANDS OFF its warm
        # replicas for the next incarnation (SIGKILL would anyway —
        # this makes a graceful stop match); without one, stopping the
        # router is stopping the fleet
        handle.close(stop_replicas=not handoff_exit,
                     handoff=handoff_exit)
        tele.close()
    return 0


def cmd_pipeline(args) -> int:
    """`pipeline`: the crash-safe train->serve deployment controller —
    watch --checkpoint-dir for newly COMMITTED steps, gate each on a
    held-out eval (on `--device`), canary-promote it through the fleet's
    rolling /reload, roll back + quarantine on failure. Journals to
    --state-dir/controller.journal so a killed controller restarts into
    the same decision. `--spawn-fleet` passes `--device` to every
    replica it spawns (before the operator's `--serve-arg`s, which
    win)."""
    from deeplearning4j_tpu_torch.deploy import (ControllerBusy,
                                                 DeploymentController)

    if bool(args.fleet_url) == bool(args.spawn_fleet):
        print("pipeline needs exactly one of --fleet-url URL or "
              "--spawn-fleet (with -m MODEL)", file=sys.stderr)
        return 2
    if args.spawn_fleet and not args.model:
        print("--spawn-fleet needs -m MODEL for the replicas",
              file=sys.stderr)
        return 2
    if args.eval_via_fleet and not args.fleet_url:
        print("--eval-via-fleet scores the LIVE fleet over HTTP and "
              "needs --fleet-url (a router endpoint, not --spawn-fleet)",
              file=sys.stderr)
        return 2
    device = _device(args)
    if device is None:
        return 2
    # canary replicas the controller promotes should boot warm too:
    # activate here so the spawned fleet's child env carries the store
    _activate_compile_cache(getattr(args, "compile_cache", None),
                            args.checkpoint_dir)
    probe = None
    if args.probe:
        probe = json.loads(args.probe)
    tele = _Telemetry(args)
    fleet = None
    handle = None
    handoff_exit = bool(args.state_dir) and not args.smoke
    ctrl = None
    try:
        if args.spawn_fleet:
            from deeplearning4j_tpu_torch.serving.fleet import (
                Fleet, ReplicaSpawner)
            from deeplearning4j_tpu_torch.serving.router import serve_fleet

            fleet = Fleet(
                spawner=ReplicaSpawner(
                    args.model,
                    serve_args=["--device", args.device] + args.serve_arg),
                state_dir=(os.path.join(args.state_dir, "fleet")
                           if args.state_dir else None),
                initial_checkpoint=(args.model
                                    if not args.model.endswith(".json")
                                    else None))
            have = sum(1 for r in fleet.snapshot()["replicas"].values()
                       if r["spawned"] and r["state"] != "evicted")
            if args.replicas > have:
                fleet.spawn(args.replicas - have)
            handle = serve_fleet(fleet, host=args.host, port=args.port)
            fleet.wait_ready(1, timeout=args.ready_timeout)
        ctrl = DeploymentController(
            args.checkpoint_dir,
            fleet=fleet,
            fleet_url=args.fleet_url,
            eval_data=args.eval_data,
            eval_via_fleet=args.eval_via_fleet,
            label_columns=args.label_columns,
            metric=args.metric,
            eval_threshold=args.eval_threshold,
            regression_margin=args.regression_margin,
            poll_interval=args.poll_interval,
            probe=probe,
            state_dir=args.state_dir,
            name=args.name,
            status_port=args.status_port,
            device=device)
    except ControllerBusy as exc:
        print(f"pipeline already running: {exc}", file=sys.stderr)
        if handle is not None:
            handle.close(stop_replicas=not handoff_exit,
                         handoff=handoff_exit)
        elif fleet is not None:
            fleet.close(stop_replicas=not handoff_exit,
                        handoff=handoff_exit)
        tele.close()
        return 3
    except BaseException:
        if handle is not None:
            handle.close(stop_replicas=not handoff_exit,
                         handoff=handoff_exit)
        elif fleet is not None:
            fleet.close(stop_replicas=not handoff_exit,
                        handoff=handoff_exit)
        tele.close()
        raise
    print(json.dumps({"pipeline": ctrl.name,
                      "checkpoint_dir": os.path.abspath(
                          args.checkpoint_dir),
                      "fleet": (handle.url if handle is not None
                                else args.fleet_url),
                      "status": ctrl.status_address,
                      "incarnation": ctrl.incarnation,
                      **tele.announce()}), flush=True)
    try:
        if args.smoke:
            return 0
        ctrl.run(max_cycles=args.cycles)
    except KeyboardInterrupt:
        pass
    finally:
        ctrl.close(release=True)
        if handle is not None:
            handle.close(stop_replicas=not handoff_exit,
                         handoff=handoff_exit)
        tele.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch",
        description="deeplearning4j on PyTorch / CUDA: "
                    "train/test/predict")
    sub = parser.add_subparsers(dest="command", required=True)

    def device_flag(p):
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the network runs (default: the CUDA "
                            "device; exits 2 without one)")

    def common(p, output_required):
        device_flag(p)
        p.add_argument("--input", "-i", required=True, help="input CSV")
        p.add_argument("--model", "-m", required=True,
                       help="conf .json (fresh net), .ckpt checkpoint, or "
                            "sharded checkpoint dir")
        p.add_argument("--label-columns", type=int, default=1,
                       help="trailing label columns (1 = integer class)")
        if output_required is not None:
            p.add_argument("--output", "-o", required=output_required,
                           help="output path")

    def telemetry_flags(p):
        p.add_argument("--metrics-port", type=int, default=None,
                       help="start a standalone Prometheus /metrics "
                            "endpoint on this port (0 = auto-assign)")
        p.add_argument("--trace", default=None, metavar="PATH",
                       help="record host spans; write Chrome-trace JSON "
                            "here on exit (docs/OBSERVABILITY.md)")

    p_train = sub.add_parser("train", help="fit a model and checkpoint it")
    common(p_train, True)
    p_train.add_argument("--epochs", type=int, default=1)
    p_train.add_argument("--batch-size", type=int, default=None,
                         help="mini-batch size (train through the "
                              "device-feed iterator path; required for "
                              "a mid-epoch --resume to line its cursor "
                              "up, and the elastic job split unit)")
    p_train.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                         help="write sharded async autosaves here during "
                              "the fit (docs/CHECKPOINTS.md); restorable "
                              "on any topology via -m DIR")
    p_train.add_argument("--checkpoint-every", type=int, default=None,
                         metavar="N",
                         help="autosave cadence in fit ticks (requires "
                              "--checkpoint-dir; default 1 when the dir "
                              "is set)")
    p_train.add_argument("--checkpoint-keep", type=int, default=3,
                         metavar="N",
                         help="committed steps to retain under "
                              "--checkpoint-dir (older steps are "
                              "pruned); raise it when a deployment "
                              "controller (`pipeline`) eval-gates the "
                              "steps so candidates outlive the "
                              "eval+canary window")
    p_train.add_argument("--resume", default=None, metavar="auto|PATH",
                         help="resume from a sharded checkpoint: 'auto' "
                              "discovers the latest COMMITTED step under "
                              "--checkpoint-dir (no step dir named); a "
                              "path pins a root or step dir. Restores "
                              "params + updater state + cursor "
                              "(docs/FAULT_TOLERANCE.md)")
    p_train.add_argument("--elastic", type=int, default=None, metavar="N",
                         help="self-healing elastic training across N "
                              "out-of-process workers (supervisor with "
                              "failure detection, bounded respawn, "
                              "straggler defense, elastic resume — "
                              "docs/FAULT_TOLERANCE.md)")
    p_train.add_argument("--max-respawns", type=int, default=3,
                         help="total replacement workers the elastic "
                              "supervisor may spawn before declaring "
                              "capacity durably lost (then: resharded "
                              "resume on the survivors)")
    p_train.add_argument("--straggler-factor", type=float, default=4.0,
                         help="evict-and-respawn a worker persistently "
                              "slower than the wave median by this "
                              "factor")
    p_train.add_argument("--status-port", type=int, default=None,
                         help="elastic: serve the supervisor's "
                              "status/healthz/metrics endpoint on this "
                              "port (0 = auto-assign)")
    p_train.add_argument("--run-timeout", type=float, default=3600.0,
                         help="elastic: overall run deadline in seconds")
    p_train.add_argument("--state-dir", default=None, metavar="DIR",
                         help="elastic: crash-safe control plane — "
                              "journal supervisor membership here "
                              "(supervisor.journal) so a restarted "
                              "supervisor (see `watchdog`) re-adopts "
                              "its surviving workers warm instead of "
                              "respawning them "
                              "(docs/FAULT_TOLERANCE.md)")
    p_train.add_argument("--compile-cache", default=None,
                         metavar="DIR|auto|off",
                         help="program store (compilecache/) for the "
                              "kernel library and the train steps' "
                              "signatures; `auto` co-locates with "
                              "--checkpoint-dir. Elastic workers "
                              "inherit it through the spawner env")
    telemetry_flags(p_train)
    p_train.set_defaults(fn=cmd_train)

    p_test = sub.add_parser("test", help="evaluate a model")
    common(p_test, None)
    p_test.set_defaults(fn=cmd_test)

    p_pred = sub.add_parser("predict", help="emit class predictions")
    common(p_pred, False)
    p_pred.set_defaults(fn=cmd_predict, label_columns=0)

    p_ckpt = sub.add_parser(
        "checkpoint",
        help="inspect sharded checkpoints (docs/CHECKPOINTS.md)")
    p_ckpt.add_argument("action", choices=["inspect"],
                        help="inspect: print a checkpoint's manifest")
    p_ckpt.add_argument("dir", help="checkpoint root (or one step dir)")
    p_ckpt.add_argument("--step", type=int, default=None,
                        help="inspect this step (default: latest committed)")
    p_ckpt.add_argument("--json", action="store_true",
                        help="single-line machine-readable output incl. "
                             "the full leaf table")
    p_ckpt.set_defaults(fn=cmd_checkpoint)

    p_serve = sub.add_parser(
        "serve", help="serve a model over HTTP (docs/SERVING.md)")
    p_serve.add_argument("--model", "-m", required=True,
                         help="conf .json (fresh net), .ckpt checkpoint, "
                              "or sharded checkpoint dir")
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=0,
                         help="0 = auto-assign (printed on start)")
    p_serve.add_argument("--replicas", type=int, default=None,
                         help="device replicas (default: all local)")
    p_serve.add_argument("--max-batch-size", type=int, default=64,
                         help="micro-batcher coalescing cap / top bucket")
    p_serve.add_argument("--max-delay-ms", type=float, default=2.0,
                         help="micro-batcher coalescing window")
    p_serve.add_argument("--slots", type=int, default=8,
                         help="continuous-batching decode slots for "
                              "/generate (docs/SERVING.md)")
    p_serve.add_argument("--page-size", type=int, default=16,
                         help="KV page size in tokens for the paged "
                              "decode pool")
    p_serve.add_argument("--prefix-cache",
                         action=argparse.BooleanOptionalAction,
                         default=True,
                         help="cross-request KV prefix sharing in the "
                              "decode pool (--no-prefix-cache disables; "
                              "docs/SERVING.md)")
    p_serve.add_argument("--fleet-kv", default="on",
                         choices=("on", "affinity-only", "off"),
                         help="this replica's half of the fleet KV "
                              "plane: `on` publishes the affinity "
                              "summary on /readyz AND serves "
                              "/kv/export + fetches from donors, "
                              "`affinity-only` publishes but never "
                              "ships pages, `off` disables both "
                              "(docs/FLEET.md \"Fleet KV plane\")")
    p_serve.add_argument("--kv-ship-timeout", type=float, default=2.0,
                         metavar="S",
                         help="budget for one donor page fetch + "
                              "install (seconds; request deadlines "
                              "cap it further). Raise it when donors "
                              "run compute-starved — expiry just "
                              "falls back to plain prefill "
                              "(docs/FLEET.md \"Fleet KV plane\")")
    p_serve.add_argument("--decode-kernel", default="auto",
                         choices=("auto", "kernel", "pallas", "gather"),
                         help="decode attention lane: kernel (the JAX "
                              "CLI's `pallas`, taken as an alias) "
                              "streams written KV pages from the pool "
                              "with the paged decode kernel, gather "
                              "materializes the dense window; auto "
                              "picks the kernel on a CUDA device")
    p_serve.add_argument("--transformer", default=None, metavar="SPEC",
                         help="enable /generate from a deterministically "
                              "initialized transformer: SPEC is a JSON "
                              "object (inline or a file path) of "
                              "TransformerConfig fields plus an optional "
                              "\"seed\" — every process given the same "
                              "SPEC serves bit-identical weights, which "
                              "is how fleet stream-failover drills get "
                              "interchangeable replicas (docs/FLEET.md)")
    p_serve.add_argument("--kv-pages", type=int, default=None,
                         help="size of the paged KV pool in pages "
                              "(default: slots * ceil(max_len / "
                              "page_size))")
    p_serve.add_argument("--horizon", type=int, default=1,
                         help="decode steps chained per dispatch "
                              "(docs/SERVING.md; mutually exclusive "
                              "with --speculation)")
    p_serve.add_argument("--speculation", type=int, default=0,
                         help="speculative decoding draft depth k "
                              "(0 = off): a drafter proposes k tokens "
                              "per slot and ONE widened verify step "
                              "accepts the longest target-matching "
                              "prefix — output stays bit-identical "
                              "(docs/SERVING.md)")
    p_serve.add_argument("--drafter", default="ngram",
                         choices=("ngram", "model"),
                         help="speculative drafter flavor: ngram = "
                              "zero-weight prompt lookup fed by the "
                              "prefix cache; model = a small draft "
                              "transformer (--draft-model)")
    p_serve.add_argument("--draft-model", default=None, metavar="SPEC",
                         help="draft transformer for --drafter model: "
                              "same JSON SPEC contract as "
                              "--transformer (TransformerConfig fields "
                              "+ \"seed\"); its vocab must match the "
                              "serving model's")
    p_serve.add_argument("--draft-window", type=int, default=32,
                         help="token window the draft model conditions "
                              "on (right-aligned slice of each slot's "
                              "history)")
    p_serve.add_argument("--no-warmup", dest="warmup",
                         action="store_false",
                         help="skip precompiling the bucket programs")
    p_serve.add_argument("--warmup-async", action="store_true",
                         help="open the socket first and warm up on a "
                              "background thread; /readyz answers 503 "
                              "until the precompile lands (how fleet "
                              "replicas hide spin-up, docs/FLEET.md)")
    p_serve.add_argument("--max-queue", type=int, default=None,
                         help="bound the /predict coalescing queue; "
                              "past it requests shed with 503 + "
                              "Retry-After")
    p_serve.add_argument("--batch-share", type=float, default=0.5,
                         help="weighted-fair fraction of decode slots "
                              "the batch SLO tier may hold while "
                              "interactive requests wait — interactive "
                              "preempts batch slots past it, losslessly "
                              "(docs/SERVING.md \"Priority tiers\")")
    p_serve.add_argument("--compile-cache", default=None,
                         metavar="DIR|auto|off",
                         help="program store (compilecache/): warm "
                              "boots load the kernel library from it "
                              "instead of running nvcc and replay the "
                              "warmup plan. `auto` co-locates with a "
                              "model/checkpoint DIR; unset still "
                              "inherits DL4J_TPU_COMPILE_CACHE from a "
                              "spawner")
    p_serve.add_argument("--warmup-plan", default="auto",
                         metavar="auto|off|PATH",
                         help="warmup plan to replay at boot (the "
                              "program set a previous replica used: "
                              "buckets, prefill groups, decode graphs)"
                              " and to record at shutdown; `auto` "
                              "stores it inside the compile cache, "
                              "`off` disables plan replay/recording")
    p_serve.add_argument("--role", default="unified",
                         choices=("unified", "prefill", "decode"),
                         help="disaggregated replica role announced on "
                              "/readyz: `prefill` computes prompt KV "
                              "and ships pages (never owns a stream), "
                              "`decode` owns streams; `unified` does "
                              "both (the default single-role fleet) "
                              "(docs/FLEET.md \"Disaggregated roles\")")
    p_serve.add_argument("--model-id", default=None, metavar="NAME",
                         help="model identity announced on /readyz for "
                              "multi-model fleet routing (requests "
                              "carry X-Model / \"model_id\"); unset "
                              "announces none and routes as `default`")
    p_serve.add_argument("--smoke", action="store_true",
                         help="start, print the address, shut down")
    telemetry_flags(p_serve)
    device_flag(p_serve)
    p_serve.set_defaults(fn=cmd_serve)

    p_fleet = sub.add_parser(
        "fleet",
        help="router tier over N replica server processes "
             "(docs/FLEET.md)")
    p_fleet.add_argument("--model", "-m", default=None,
                         help="checkpoint/conf served by spawned "
                              "replicas (optional with --attach)")
    p_fleet.add_argument("--replicas", type=int, default=2,
                         help="replica processes to spawn locally "
                              "(0 = attach-only)")
    p_fleet.add_argument("--attach", action="append", default=[],
                         metavar="URL",
                         help="attach an already-running replica "
                              "endpoint (repeatable)")
    p_fleet.add_argument("--host", default="127.0.0.1")
    p_fleet.add_argument("--port", type=int, default=0,
                         help="router port; 0 = auto-assign (printed)")
    p_fleet.add_argument("--heartbeat-interval", type=float, default=0.5)
    p_fleet.add_argument("--heartbeat-timeout", type=float, default=3.0,
                         help="evict a replica whose liveness probe "
                              "has not succeeded for this long")
    p_fleet.add_argument("--shed-high-water", type=int, default=None,
                         help="shed (503 + Retry-After) when this many "
                              "requests are in flight fleet-wide")
    p_fleet.add_argument("--batch-high-water", type=int, default=None,
                         help="shed BATCH-tier requests once this many "
                              "are in flight fleet-wide (default: half "
                              "of --shed-high-water) so bulk work sheds "
                              "before the interactive lane feels "
                              "pressure (docs/FLEET.md)")
    p_fleet.add_argument("--request-timeout", type=float, default=60.0,
                         help="per-hop /predict socket timeout ceiling; "
                              "requests carrying X-Deadline-Ms derive "
                              "their hop timeouts from the remaining "
                              "budget instead (docs/SERVING.md)")
    p_fleet.add_argument("--retry-budget", type=int, default=2,
                         help="max /predict retries on healthy peers "
                              "after a replica failure or timeout")
    p_fleet.add_argument("--stream-resume-attempts", type=int, default=2,
                         help="max mid-stream failover resumes per "
                              "/generate before the router gives up "
                              "with the in-band retryable error "
                              "(0 disables durable-stream failover; "
                              "docs/FLEET.md \"Stream failover\")")
    p_fleet.add_argument("--breaker-threshold", type=int, default=3,
                         help="consecutive request timeouts that trip a "
                              "replica's circuit breaker open (evicting "
                              "hung-but-TCP-alive members, docs/FLEET.md)")
    p_fleet.add_argument("--breaker-reset", type=float, default=None,
                         metavar="S",
                         help="open -> half-open wait before the /readyz "
                              "readmission probe (default: 4x the "
                              "heartbeat interval)")
    p_fleet.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                         help="enable the autoscaling hook between MIN "
                              "and MAX replicas (queue-depth driven)")
    p_fleet.add_argument("--ready-timeout", type=float, default=180.0,
                         help="wait this long for the first replica to "
                              "pass /readyz before announcing")
    p_fleet.add_argument("--serve-arg", action="append", default=[],
                         metavar="ARG",
                         help="extra flag forwarded to each spawned "
                              "replica's `serve` (repeatable)")
    p_fleet.add_argument("--fleet-kv", default="on",
                         choices=("on", "affinity-only", "off"),
                         help="fleet KV plane mode, applied to BOTH "
                              "the router (prefix-affinity placement, "
                              "donor hints) and every spawned replica "
                              "(summary publication, page shipping); "
                              "`affinity-only` routes by prefix but "
                              "never ships pages "
                              "(docs/FLEET.md \"Fleet KV plane\")")
    p_fleet.add_argument("--state-dir", default=None, metavar="DIR",
                         help="crash-safe control plane: journal "
                              "replica membership here (fleet.journal) "
                              "so a restarted router (see `watchdog`) "
                              "re-adopts the warm fleet via /readyz — "
                              "zero respawns, zero recompiles "
                              "(docs/FLEET.md router-restart runbook)")
    p_fleet.add_argument("--compile-cache", default=None,
                         metavar="DIR|auto|off",
                         help="program store exported to every "
                              "spawned replica: respawns and autoscale "
                              "spin-ups boot warm; `auto` co-locates "
                              "with a model/checkpoint DIR")
    p_fleet.add_argument("--roles", default=None,
                         metavar="ROLE=N[,ROLE=N...]",
                         help="disaggregated role pools to spawn, e.g. "
                              "`prefill=1,decode=2`: each pool's "
                              "replicas get the matching `--role` "
                              "serve flag and are autoscaled "
                              "independently (docs/FLEET.md "
                              "\"Disaggregated roles\"). Replaces "
                              "--replicas for spawning")
    p_fleet.add_argument("--models", default=None,
                         metavar="NAME=PATH[,NAME=PATH...]",
                         help="multi-model fleet: spawn one pool per "
                              "named model (each replica serves PATH "
                              "and announces `--model-id NAME`); "
                              "combined with --roles every model gets "
                              "the full role layout. Requests route by "
                              "X-Model / \"model_id\"")
    p_fleet.add_argument("--smoke", action="store_true",
                         help="start, print the address, shut down "
                              "(stops spawned replicas)")
    telemetry_flags(p_fleet)
    p_fleet.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                         help="device of every spawned replica (default: "
                              "the CUDA device; a replica without one "
                              "exits and its spawn fails)")
    p_fleet.set_defaults(fn=cmd_fleet)

    p_watch = sub.add_parser(
        "watchdog",
        help="restart-under-backoff wrapper supervising a control-"
             "plane subcommand (docs/FAULT_TOLERANCE.md)")
    p_watch.add_argument("--max-restarts", type=int, default=10,
                         help="give up after this many non-zero exits")
    p_watch.add_argument("--backoff", type=float, default=1.0,
                         help="initial restart backoff in seconds "
                              "(doubles per restart)")
    p_watch.add_argument("--backoff-max", type=float, default=30.0,
                         help="backoff ceiling in seconds")
    p_watch.add_argument("--stop-grace", type=float, default=10.0,
                         help="seconds a forwarded SIGTERM/SIGINT may "
                              "take before the child is killed")
    p_watch.add_argument("cmd", nargs=argparse.REMAINDER,
                         help="the wrapped subcommand, after `--`: "
                              "e.g. `-- train --elastic 2 "
                              "--state-dir S ...`")
    p_watch.set_defaults(fn=cmd_watchdog)

    p_eval = sub.add_parser(
        "eval",
        help="one-shot held-out eval of a checkpoint — the pipeline's "
             "promotion gate, runnable by hand (docs/PIPELINE.md)")
    p_eval.add_argument("--model", "-m", required=True,
                        help="conf .json (fresh net), .ckpt checkpoint, "
                             "or sharded checkpoint dir")
    p_eval.add_argument("--data", required=True,
                        help="held-out CSV (features + trailing labels)")
    p_eval.add_argument("--label-columns", type=int, default=1,
                        help="trailing label columns (1 = integer class)")
    p_eval.add_argument("--step", type=int, default=None,
                        help="pin a committed step in a sharded dir "
                             "(default: latest committed)")
    p_eval.add_argument("--json", action="store_true",
                        help="single-line machine-readable output")
    device_flag(p_eval)
    p_eval.set_defaults(fn=cmd_eval)

    p_batch = sub.add_parser(
        "batch",
        help="bulk generation through a router on the batch SLO tier "
             "with crash-safe resumable progress (docs/SERVING.md "
             "\"Priority tiers\")")
    p_batch.add_argument("--url", required=True,
                         help="router (or single replica) base URL")
    p_batch.add_argument("--input", "-i", required=True,
                         help="JSONL prompts: each line a token list "
                              "or {\"prompt\": [...], "
                              "\"max_tokens\": N}")
    p_batch.add_argument("--output", "-o", required=True,
                         help="JSONL results, one line per input row "
                              "({row, tokens, finish_reason}); "
                              "appended to on resume")
    p_batch.add_argument("--journal", default=None, metavar="PATH",
                         help="progress cursor journal (default: "
                              "OUTPUT.journal); delete it and the "
                              "output to restart from row 0")
    p_batch.add_argument("--max-tokens", type=int, default=16,
                         help="decode budget for rows that do not "
                              "carry their own")
    p_batch.add_argument("--batch-size", type=int, default=8,
                         help="rows per /generate request (admitted "
                              "as one group)")
    p_batch.add_argument("--eos-id", type=int, default=None,
                         help="stop rows early at this token id")
    p_batch.add_argument("--timeout", type=float, default=300.0,
                         help="per-request socket timeout — batch "
                              "work queues behind interactive "
                              "admission and may be preempted "
                              "mid-stream, so keep it generous")
    p_batch.add_argument("--max-shed-retries", type=int, default=120,
                         help="per-chunk 503 sheds to wait out before "
                              "giving up (each honors the tier-aware "
                              "Retry-After, capped at 5s a beat)")
    p_batch.add_argument("--progress", action="store_true",
                         help="print a JSON progress line per chunk")
    p_batch.set_defaults(fn=cmd_batch)

    p_pipe = sub.add_parser(
        "pipeline",
        help="crash-safe train->serve deployment controller: watch -> "
             "eval gate -> canary promote -> rollback "
             "(docs/PIPELINE.md)")
    p_pipe.add_argument("--checkpoint-dir", required=True, metavar="DIR",
                        help="sharded checkpoint root to watch for "
                             "newly COMMITTED steps (the training "
                             "side's --checkpoint-dir)")
    p_pipe.add_argument("--fleet-url", default=None, metavar="URL",
                        help="router URL of an already-running fleet "
                             "(`fleet` subcommand) to drive over HTTP")
    p_pipe.add_argument("--spawn-fleet", action="store_true",
                        help="spawn the serving fleet in-process "
                             "instead (needs -m MODEL; starts a router "
                             "+ --replicas replica processes)")
    p_pipe.add_argument("--model", "-m", default=None,
                        help="checkpoint/conf served by --spawn-fleet "
                             "replicas at boot")
    p_pipe.add_argument("--replicas", type=int, default=2,
                        help="--spawn-fleet: replica processes")
    p_pipe.add_argument("--host", default="127.0.0.1")
    p_pipe.add_argument("--port", type=int, default=0,
                        help="--spawn-fleet: router port (0 = auto)")
    p_pipe.add_argument("--ready-timeout", type=float, default=180.0,
                        help="--spawn-fleet: wait for the first replica")
    p_pipe.add_argument("--serve-arg", action="append", default=[],
                        metavar="ARG",
                        help="--spawn-fleet: extra flag forwarded to "
                             "each replica's `serve` (repeatable)")
    p_pipe.add_argument("--eval-data", default=None, metavar="CSV",
                        help="held-out CSV for the promotion gate "
                             "(omitted = gate disabled: every committed "
                             "step is canaried)")
    p_pipe.add_argument("--eval-via-fleet", action="store_true",
                        help="refresh the champion's regression "
                             "baseline by scoring --eval-data against "
                             "the LIVE fleet on the batch SLO tier "
                             "before each gate (needs --fleet-url; "
                             "docs/PIPELINE.md)")
    p_pipe.add_argument("--label-columns", type=int, default=1)
    p_pipe.add_argument("--metric", default="f1",
                        choices=("f1", "accuracy", "precision",
                                 "recall"),
                        help="gate metric from the held-out eval")
    p_pipe.add_argument("--eval-threshold", type=float, default=0.0,
                        help="absolute gate: quarantine a candidate "
                             "scoring below this")
    p_pipe.add_argument("--regression-margin", type=float, default=0.05,
                        help="relative gate: quarantine a candidate "
                             "scoring more than this below the current "
                             "champion's gate score")
    p_pipe.add_argument("--poll-interval", type=float, default=2.0,
                        help="checkpoint-dir watch interval in seconds "
                             "(bounded polling; no inotify)")
    p_pipe.add_argument("--probe", default=None, metavar="JSON",
                        help="validation probe body forwarded to the "
                             "canary's /predict before promotion, e.g. "
                             "'{\"inputs\": [[0,0,0,0]]}'")
    p_pipe.add_argument("--state-dir", default=None, metavar="DIR",
                        help="crash-safe control plane: journal the "
                             "controller's decision state here "
                             "(controller.journal) so a restart (see "
                             "`watchdog`) resumes mid-promotion to a "
                             "consistent verdict; --spawn-fleet also "
                             "journals the fleet under DIR/fleet")
    p_pipe.add_argument("--name", default=None,
                        help="pipeline label on dl4j_pipeline_* series")
    p_pipe.add_argument("--status-port", type=int, default=None,
                        help="serve the controller's status/healthz/"
                             "metrics endpoint (0 = auto-assign)")
    p_pipe.add_argument("--cycles", type=int, default=None, metavar="N",
                        help="exit 0 after N watch cycles (default: "
                             "run until stopped)")
    p_pipe.add_argument("--compile-cache", default=None,
                        metavar="DIR|auto|off",
                        help="program store exported to canary/"
                             "promoted replicas; `auto` co-locates with "
                             "the watched checkpoint dir")
    p_pipe.add_argument("--smoke", action="store_true",
                        help="start, print the announce line, shut down")
    telemetry_flags(p_pipe)
    p_pipe.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the eval gate runs, and the device "
                             "every --spawn-fleet replica is given "
                             "(default: the CUDA device; exits 2 without "
                             "one)")
    p_pipe.set_defaults(fn=cmd_pipeline)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
