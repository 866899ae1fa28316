"""One-shot held-out evaluation of a checkpoint — the eval gate's meat.

`evaluate_checkpoint(model, data)` loads any checkpoint the serving
stack can load (sharded directory, single-file npz, or a conf .json for
a fresh net), runs the held-out CSV through `Evaluation`, and returns
the metrics dict both consumers speak:

- `cli eval -m <checkpoint> --data <csv> --json` prints it (the same
  {"f1", "accuracy", "precision", "recall"} shape `cli test` emits, plus
  the checkpoint identity), and
- the deployment controller's eval gate (deploy/controller.py) compares
  it against its absolute threshold and the current champion's score
  before offering a candidate to the fleet (docs/PIPELINE.md).

`evaluate_via_fleet(url, data)` is the live twin: it scores whatever a
serving endpoint (fleet router or single replica) CURRENTLY serves by
driving the held-out set through ``POST /predict`` — on the BATCH SLO
tier (docs/SERVING.md "Priority tiers"), because bulk scoring is
offline work that must never compete with interactive admission: it
sheds first at the batch lane's lower high-water mark and honors the
tier-aware ``Retry-After`` on a 503 before retrying. The deployment
controller uses it to refresh the champion's baseline from the live
fleet before the regression comparison (`eval_via_fleet=`).

Held-out CSV shape matches the rest of the CLI: one row per example,
features then the label column(s) — an integer class column when
`label_columns == 1` (one-hot expanded against the MODEL's output
width, so a file missing the top class cannot shrink the label space).

The port's copy of the JAX package's `eval/holdout.py`: the network is
loaded onto `device` (None = the CUDA device, raising without one; the
tests pass "cpu"), and the metrics dict is the JAX package's key for
key.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

__all__ = ["evaluate_checkpoint", "evaluate_via_fleet",
           "load_holdout_csv"]


def load_holdout_csv(path: str, label_columns: int = 1,
                     n_classes: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(features, one-hot labels) from a labelled CSV. Raises on a
    label-free file — a gate with no labels cannot gate."""
    if label_columns < 1:
        raise ValueError("held-out evaluation needs label_columns >= 1")
    data = np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
    x = data[:, :-label_columns]
    y = data[:, -label_columns:]
    if label_columns == 1:  # integer class column -> one-hot
        labels = y.astype(int).ravel()
        classes = n_classes if n_classes else int(labels.max()) + 1
        if labels.max() >= classes:
            raise ValueError(
                f"label {labels.max()} out of range for model with "
                f"{classes} output classes")
        y = np.eye(classes, dtype=np.float32)[labels]
    return x, y


def _load_net(model: str, step: Optional[int] = None, device=None):
    """(net, checkpoint_step_or_None) for a sharded dir, npz file, or
    conf .json — the same dispatch the serving reload path uses."""
    if os.path.isdir(model):
        from deeplearning4j_tpu_torch.checkpoint.restore import restore_network

        net, info = restore_network(model, step, device=device)
        return net, info.get("step", step)
    if model.endswith(".json"):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        with open(model) as f:
            return MultiLayerNetwork.from_config_json(
                f.read(), device=device), None
    if step is not None:
        raise ValueError(
            f"step={step} was requested but {model!r} is a single-file "
            "checkpoint with no steps")
    from deeplearning4j_tpu_torch.scaleout.checkpoint import load_checkpoint

    net, _ = load_checkpoint(model, device=device)
    return net, None


def evaluate_via_fleet(url: str, data: str, *,
                       label_columns: int = 1,
                       n_classes: Optional[int] = None,
                       batch_size: int = 64,
                       timeout: float = 120.0,
                       max_shed_retries: int = 8) -> dict:
    """Score the held-out CSV against a LIVE serving endpoint (fleet
    router or single replica) instead of loading weights locally —
    the metrics describe whatever the endpoint currently serves.

    Every request rides the BATCH SLO tier: the `X-Priority: batch`
    header (and a matching `"priority"` body field, for endpoints
    reached without the router) keeps bulk scoring out of the
    interactive lane. A 503 shed is honored, not fatal: the reply's
    `retry_after_ms` (derived from the batch lane's own backlog) is
    waited out — capped at 5s a beat, `max_shed_retries` beats total —
    before the chunk retries. Other HTTP errors raise RuntimeError
    (the caller decides whether that is an infra failure)."""
    import urllib.error
    import urllib.request

    from deeplearning4j_tpu_torch.serving.errors import (
        PRIORITY_HEADER, TIER_BATCH)

    x, y = load_holdout_csv(data, label_columns, n_classes)
    url = url.rstrip("/")
    start = time.perf_counter()
    outs = []
    sheds = 0
    for lo in range(0, x.shape[0], batch_size):
        body = json.dumps({
            "inputs": x[lo:lo + batch_size].tolist(),
            "priority": TIER_BATCH}).encode()
        while True:
            req = urllib.request.Request(
                url + "/predict", data=body,
                headers={"Content-Type": "application/json",
                         PRIORITY_HEADER: TIER_BATCH})
            try:
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    payload = json.loads(r.read())
                break
            except urllib.error.HTTPError as e:
                raw = e.read()
                if e.code == 503 and sheds < max_shed_retries:
                    sheds += 1
                    try:
                        retry_ms = json.loads(raw).get(
                            "retry_after_ms", 1000)
                    except ValueError:
                        retry_ms = 1000
                    time.sleep(min(5.0, max(0.05, retry_ms / 1000.0)))
                    continue
                raise RuntimeError(
                    f"fleet eval: /predict answered {e.code}: "
                    f"{raw.decode(errors='replace')[:200]}") from e
        outs.append(np.asarray(payload["outputs"], dtype=np.float32))
    ev = Evaluation()
    ev.eval(y, np.concatenate(outs, axis=0))
    return {
        "f1": ev.f1(),
        "accuracy": ev.accuracy(),
        "precision": ev.precision(),
        "recall": ev.recall(),
        "n": int(x.shape[0]),
        "path": url,
        "step": None,
        "via": "fleet",
        "tier": TIER_BATCH,
        "shed_retries": sheds,
        "eval_seconds": round(time.perf_counter() - start, 6),
    }


def evaluate_checkpoint(model: str, data: str, *,
                        label_columns: int = 1,
                        step: Optional[int] = None, device=None) -> dict:
    """Evaluate `model` (checkpoint path) on the held-out CSV `data`.

    Returns {"f1", "accuracy", "precision", "recall", "n", "path",
    "step", "eval_seconds"} — step is the checkpoint's committed step
    when it has one (sharded dirs), else None. The network runs on
    `device` (None = the CUDA device).
    """
    start = time.perf_counter()
    net, ck_step = _load_net(model, step, device)
    try:
        n_out = net.conf.confs[-1].n_out or None
    except (AttributeError, IndexError):
        n_out = None
    x, y = load_holdout_csv(data, label_columns, n_out)
    ev = Evaluation()
    ev.eval(y, net.output(x))
    return {
        "f1": ev.f1(),
        "accuracy": ev.accuracy(),
        "precision": ev.precision(),
        "recall": ev.recall(),
        "n": int(x.shape[0]),
        "path": model,
        "step": ck_step,
        "eval_seconds": round(time.perf_counter() - start, 6),
    }
