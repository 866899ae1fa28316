"""The port's cluster-infrastructure tier on the CPU: provisioning
transports and the URI-addressed artifact plane
(`deeplearning4j_tpu_torch.scaleout.storage` / `.provision`), the JAX
package's `tests/test_provision_storage.py` case for case, plus a store
written by either package read by the other (host code: the npz+JSON
payload is shared)."""

import os
import sys

import numpy as np
import pytest

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.scaleout import (
    ArtifactStore,
    ClusterSetup,
    HostProvisioner,
    LocalTransport,
    StorageDataSetIterator,
)


class TestArtifactStore:
    def _store(self, tmp_path):
        return ArtifactStore(str(tmp_path / "bucket"))

    def test_put_get_round_trip(self, tmp_path):
        store = self._store(tmp_path)
        store.put_bytes("run1/model.bin", b"\x00\x01payload")
        assert store.get_bytes("run1/model.bin") == b"\x00\x01payload"
        assert store.exists("run1/model.bin")
        store.delete("run1/model.bin")
        assert not store.exists("run1/model.bin")

    def test_listing_sorted_and_skips_tmp(self, tmp_path):
        store = self._store(tmp_path)
        store.put_bytes("b/2.bin", b"2")
        store.put_bytes("a/1.bin", b"1")
        with open(os.path.join(store.root, "junk.tmp"), "wb") as f:
            f.write(b"inflight")
        assert store.keys() == [os.path.join("a", "1.bin"),
                                os.path.join("b", "2.bin")]
        assert list(store) == store.keys()
        assert store.keys("a") == [os.path.join("a", "1.bin")]

    def test_key_escape_rejected(self, tmp_path):
        store = self._store(tmp_path)
        with pytest.raises(ValueError, match="escapes"):
            store.put_bytes("../../etc/evil", b"x")

    def test_file_upload_download(self, tmp_path):
        store = self._store(tmp_path)
        src = tmp_path / "local.bin"
        src.write_bytes(b"abc")
        store.upload_file(str(src), "stage/local.bin")
        dest = tmp_path / "out" / "local.bin"
        store.download_file("stage/local.bin", str(dest))
        assert dest.read_bytes() == b"abc"

    def test_gs_scheme_resolves_via_mount(self, tmp_path):
        mount = tmp_path / "gcs-mount"
        store = ArtifactStore("gs://bucket/run",
                              mounts={"gs": str(mount)})
        store.put_bytes("ckpt.bin", b"x")
        assert (mount / "bucket" / "run" / "ckpt.bin").read_bytes() == b"x"

    def test_gs_scheme_without_mount_errors(self):
        env = os.environ.pop("DL4J_TPU_ARTIFACT_ROOT", None)
        try:
            with pytest.raises(ValueError, match="mount"):
                ArtifactStore("gs://bucket/run")
        finally:
            if env is not None:
                os.environ["DL4J_TPU_ARTIFACT_ROOT"] = env


class TestStorageDataSetIterator:
    def test_streams_datasets_in_key_order(self, tmp_path):
        store = ArtifactStore(str(tmp_path))
        for i in range(3):
            ds = DataSet(np.full((4, 2), i, np.float32),
                         np.eye(2, dtype=np.float32)[[0, 1, 0, 1]])
            store.put_dataset(f"train/part-{i}.bin", ds)
        it = StorageDataSetIterator(store, "train")
        assert it.input_columns() == 2
        assert it.total_outcomes() == 2
        vals = []
        while it.has_next():
            vals.append(float(it.next().features[0, 0]))
        assert vals == [0.0, 1.0, 2.0]
        it.reset()
        assert it.has_next()

    def test_empty_prefix_errors(self, tmp_path):
        store = ArtifactStore(str(tmp_path))
        with pytest.raises(ValueError, match="no datasets"):
            StorageDataSetIterator(store, "nothing")


class TestProvisioning:
    def test_host_provisioner_upload_and_run_local(self, tmp_path):
        script = tmp_path / "setup.sh"
        script.write_text("echo provisioned-$1 > %s/marker.txt\n" % tmp_path)
        prov = HostProvisioner(LocalTransport())
        cwd = os.getcwd()
        os.chdir(tmp_path)
        try:
            rc, out = prov.upload_and_run(str(script))
        finally:
            os.chdir(cwd)
        assert rc == 0
        assert (tmp_path / "marker.txt").read_text().startswith("provisioned")

    def test_run_remote_command(self):
        prov = HostProvisioner(LocalTransport())
        rc, out = prov.run_remote_command(
            [sys.executable, "-c", "print(6*7)"])
        assert rc == 0
        assert "42" in out

    def test_cluster_setup_fans_out(self, tmp_path):
        """Provision 2 'hosts' (local transports) — each runs the worker
        command; with a stub python that records its argv we verify the
        launcher invocation without a live master."""
        record = tmp_path / "calls"
        record.mkdir()
        stub = tmp_path / "stub.py"
        stub.write_text(
            "import sys, os, uuid\n"
            "open(os.path.join(%r, uuid.uuid4().hex), 'w')"
            ".write(' '.join(sys.argv[1:]))\n" % str(record))
        # python=interpreter + stub-as-module trick: run stub directly
        cs = ClusterSetup({"w0": LocalTransport(), "w1": LocalTransport()},
                          registry_root=str(tmp_path / "reg"),
                          run_name="demo", python=sys.executable)
        # swap the worker command to drive the stub instead of the real
        # launcher (which would block waiting for a master)
        cs._worker_command = lambda wid: [
            sys.executable, str(stub), "worker", "--registry",
            cs.registry_root, "--run", cs.run_name, "--worker-id", wid]
        results = cs.provision_workers(detach=False)
        assert set(results) == {"w0", "w1"}
        assert all(rc == 0 for rc, _ in results.values())
        recorded = [f.read_text() for f in record.iterdir()]
        assert len(recorded) == 2
        assert any("--worker-id w0" in r for r in recorded)
        assert any("--worker-id w1" in r for r in recorded)

    def test_setup_script_failure_isolated_per_host(self, tmp_path,
                                                    monkeypatch):
        # upload_and_run stages the script into the transport's working
        # dir (default "."), so isolate cwd or the copy lands in the repo
        monkeypatch.chdir(tmp_path)
        bad = tmp_path / "bad.sh"
        bad.write_text("exit 3\n")
        cs = ClusterSetup({"w0": LocalTransport()},
                          registry_root="unused", run_name="demo",
                          setup_script=str(bad))
        results = cs.provision_workers(detach=False)
        rc, out = results["w0"]
        assert rc == -1
        assert "setup script failed" in out


class TestSshTransport:
    """Command construction only — no live ssh in the test image."""

    def test_ssh_command_shape(self):
        from deeplearning4j_tpu_torch.scaleout.provision import SshTransport

        t = SshTransport("worker-1.example", user="trainer", port=2222,
                         key_file="/keys/id_ed25519")
        base = t._ssh_base()
        assert base[0] == "ssh"
        assert "-p" in base and base[base.index("-p") + 1] == "2222"
        assert "-i" in base and base[base.index("-i") + 1] == "/keys/id_ed25519"
        assert "BatchMode=yes" in base  # never prompt for passwords
        assert base[-1] == "trainer@worker-1.example"

    def test_ssh_without_user_or_key(self):
        from deeplearning4j_tpu_torch.scaleout.provision import SshTransport

        base = SshTransport("host-a")._ssh_base()
        assert base[-1] == "host-a"
        assert "-i" not in base

    def test_upload_failure_raises(self):
        from deeplearning4j_tpu_torch.scaleout.provision import SshTransport

        t = SshTransport("256.0.0.1", connect_timeout=1)  # unroutable
        with pytest.raises(RuntimeError, match="scp"):
            t.upload("/etc/hostname", "/tmp/x")


class TestAcrossPackages:
    def test_datasets_written_by_either_package_read_in_the_other(
            self, tmp_path):
        import torch

        from deeplearning4j_tpu.scaleout import storage as jstorage

        rng = np.random.RandomState(0)
        f = rng.randn(4, 3).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
        port = ArtifactStore(str(tmp_path))
        theirs = jstorage.ArtifactStore(str(tmp_path))
        # a device tensor DataSet is stored as host numpy
        port.put_dataset("p/0.bin", DataSet(torch.from_numpy(f),
                                            torch.from_numpy(y)))
        from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
        theirs.put_dataset("j/0.bin", JDataSet(f, y))
        assert port.get_bytes("p/0.bin") == theirs.get_bytes("j/0.bin")
        back = theirs.get_dataset("p/0.bin")
        np.testing.assert_array_equal(np.asarray(back.features), f)
        mine = port.get_dataset("j/0.bin")
        np.testing.assert_array_equal(mine.labels, y)
        assert port.keys() == theirs.keys()

    def test_cluster_setup_starts_the_port_launcher(self, tmp_path):
        cs = ClusterSetup({"w0": LocalTransport()},
                          registry_root=str(tmp_path), run_name="r")
        argv = cs._worker_command("w0")
        assert argv[1:3] == ["-m",
                             "deeplearning4j_tpu_torch.scaleout.launcher"]
        assert argv[3:] == ["worker", "--registry", str(tmp_path), "--run",
                            "r", "--worker-id", "w0"]
