"""The port's box creation (`deeplearning4j_tpu_torch.scaleout.boxes`) on
the CPU, the JAX package's `tests/test_boxes.py` case for case: command
construction and host collection with a recording runner (no cloud API
is reached), the LocalBoxCreator tier feeding ClusterSetup, and the
same gcloud argv as the JAX package's creator."""

import json
import sys

import pytest

from deeplearning4j_tpu_torch.scaleout.boxes import (GceTpuBoxCreator,
                                                     LocalBoxCreator,
                                                     cluster_hosts)
from deeplearning4j_tpu_torch.scaleout.provision import (ClusterSetup,
                                                         LocalTransport,
                                                         SshTransport)


class RecordingRunner:
    """Records argv; serves canned describe responses."""

    def __init__(self, hosts_per_slice):
        self.calls = []
        self.hosts_per_slice = hosts_per_slice

    def __call__(self, argv):
        self.calls.append(list(argv))
        if "describe" in argv:
            name = argv[argv.index("describe") + 1]
            return json.dumps({"networkEndpoints": [
                {"ipAddress": f"{name}-host{j}"}
                for j in range(self.hosts_per_slice)]})
        return ""


class TestGceTpuBoxCreator:
    def test_create_builds_gcloud_commands_and_collects_hosts(self):
        runner = RecordingRunner(hosts_per_slice=4)  # e.g. v5e-16 slice
        creator = GceTpuBoxCreator(
            "trainer", zone="us-central1-a", accelerator_type="v5litepod-16",
            runtime_version="v2-alpha-tpuv5-lite", n_slices=2,
            project="proj-1", runner=runner)
        hosts = creator.create()
        # one create + one describe per slice
        creates = [c for c in runner.calls if "create" in c]
        assert len(creates) == 2
        assert creates[0][:6] == ["gcloud", "compute", "tpus", "tpu-vm",
                                  "create", "trainer-0"]
        assert "--accelerator-type" in creates[0]
        assert creates[0][creates[0].index("--accelerator-type") + 1] == \
            "v5litepod-16"
        assert "--project" in creates[0]
        # a 2-slice x 4-host cluster yields 8 worker hosts
        assert len(hosts) == 8
        assert hosts[0] == "trainer-0-host0"
        assert creator.created == ["trainer-0", "trainer-1"]

    def test_blow_away_deletes_created_slices(self):
        runner = RecordingRunner(hosts_per_slice=1)
        creator = GceTpuBoxCreator("x", zone="z", n_slices=2, runner=runner)
        creator.create()
        creator.blow_away()
        deletes = [c for c in runner.calls if "delete" in c]
        assert [c[c.index("delete") + 1] for c in deletes] == ["x-0", "x-1"]
        assert all("--quiet" in c for c in deletes)
        assert creator.created == []

    def test_blow_away_survives_partial_failure(self):
        """One failed delete must not leak the rest (billed machines):
        not-found counts as success, transient failures stay tracked for
        retry, and every slice gets its attempt."""
        class FlakyRunner(RecordingRunner):
            def __call__(self, argv):
                out = super().__call__(argv)
                if "delete" in argv:
                    name = argv[argv.index("delete") + 1]
                    if name == "x-0":
                        raise RuntimeError("gcloud failed: NOT FOUND")
                    if name == "x-1":
                        raise RuntimeError("gcloud failed: quota flake")
                return out

        runner = FlakyRunner(hosts_per_slice=1)
        creator = GceTpuBoxCreator("x", zone="z", n_slices=3, runner=runner)
        creator.create()
        with pytest.raises(RuntimeError, match="x-1"):
            creator.blow_away()
        deletes = [c for c in runner.calls if "delete" in c]
        assert len(deletes) == 3  # every slice attempted
        assert creator.created == ["x-1"]  # only the flake remains

    def test_describe_without_endpoints_raises(self):
        class EmptyRunner(RecordingRunner):
            def __call__(self, argv):
                if "describe" in argv:
                    return json.dumps({"networkEndpoints": []})
                return super().__call__(argv)

        creator = GceTpuBoxCreator("x", zone="z",
                                   runner=EmptyRunner(hosts_per_slice=0))
        with pytest.raises(RuntimeError, match="endpoints"):
            creator.create()

    def test_transport_is_ssh_with_user(self):
        creator = GceTpuBoxCreator("x", zone="z", ssh_user="trainer",
                                   runner=RecordingRunner(1))
        t = creator.transport_for("10.0.0.5")
        assert isinstance(t, SshTransport)
        assert t._ssh_base()[-1] == "trainer@10.0.0.5"


class TestLocalBoxCreatorWithClusterSetup:
    def test_cluster_hosts_feeds_cluster_setup(self, tmp_path):
        hosts = cluster_hosts(LocalBoxCreator(2))
        assert set(hosts) == {"w0", "w1"}
        assert all(isinstance(t, LocalTransport) for t in hosts.values())
        cs = ClusterSetup(hosts, registry_root=str(tmp_path / "reg"),
                          run_name="demo", python=sys.executable)
        # swap in a no-op worker command (the provisioning layer itself
        # is exercised; a live master isn't needed)
        cs._worker_command = lambda wid: [sys.executable, "-c",
                                          "print('ok-%s')" % wid]
        results = cs.provision_workers(detach=False)
        assert all(rc == 0 for rc, _ in results.values())


def test_the_gcloud_argv_is_the_jax_packages():
    from deeplearning4j_tpu.scaleout.boxes import \
        GceTpuBoxCreator as JaxCreator

    kw = dict(zone="z", accelerator_type="v5litepod-16", n_slices=2,
              project="p", network="n", ssh_user="u")
    ours, theirs = RecordingRunner(2), RecordingRunner(2)
    a = GceTpuBoxCreator("x", runner=ours, **kw)
    b = JaxCreator("x", runner=theirs, **kw)
    assert a.create() == b.create()
    a.blow_away()
    b.blow_away()
    assert ours.calls == theirs.calls
