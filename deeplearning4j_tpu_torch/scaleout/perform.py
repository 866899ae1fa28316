"""Worker performers: the compute plugged into distributed workers, the
counterpart of the JAX package's `scaleout/perform.py`.

Parity: reference NeuralNetWorkPerformer.java:32-66 /
BaseMultiLayerNetworkWorkPerformer.java:32-57 — deserialize the conf JSON,
build the net, fit on the job's DataSet, result = packed params;
`update()` = setParameters. Configs travel as JSON strings (the reference's
wire format, SURVEY §5 config system).

Device: the network lives on the performer's `device` (the conf's
"device" key; None = the CUDA device, raising without one), so a worker
spawned with `{"device": "cuda"}` in its performer conf trains on the
card and one with "cpu" on the host. A job's result is the packed
vector as a host float32 numpy array: one device-to-host copy per job,
as the JAX package's `np.asarray(net.params())`. `update` installs the
global vector on the network's device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.scaleout.api import Job, WorkerPerformer


class NeuralNetWorkPerformer(WorkerPerformer):
    """Fit a MultiLayerNetwork on each job's DataSet; emit packed params."""

    CONF_JSON = "conf_json"  # config key (reference WORKER_PERFORMER wiring)
    DEVICE = "device"  # where the network trains (None = the CUDA device)

    def __init__(self, conf_json: str = None, epochs: int = 1,
                 device: Optional[str] = None):
        self.conf_json = conf_json
        self.epochs = epochs
        self.device = device
        self._net = None

    def setup(self, conf: Dict[str, Any]) -> None:
        self.conf_json = conf[self.CONF_JSON]
        self.epochs = int(conf.get("epochs", 1))
        self.device = conf.get(self.DEVICE)
        self._ensure_net()

    def _ensure_net(self):
        if self._net is None:
            if self.conf_json is None:
                raise ValueError("NeuralNetWorkPerformer needs conf_json")
            from deeplearning4j_tpu_torch.nn.multilayer import \
                MultiLayerNetwork
            self._net = MultiLayerNetwork.from_config_json(
                self.conf_json, device=self.device)
        return self._net

    @property
    def network(self):
        return self._ensure_net()

    def perform(self, job: Job) -> None:
        net = self._ensure_net()
        ds = job.work
        net.fit(ds.features, ds.labels, epochs=self.epochs)
        job.result = net.params().to(torch.float32).cpu().numpy()

    def update(self, *args: Any) -> None:
        """Install new global parameters (reference update() = setParams)."""
        net = self._ensure_net()
        net.set_parameters(np.asarray(args[0]))
