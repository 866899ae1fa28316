"""The PyTorch port's public surface held against the JAX package's, on
the CPU: every name a JAX `__init__.py` imports exists on the port's
counterpart package (an `ast` walk of the JAX files: nothing of the JAX
package is imported to list them), every `.py` file of the JAX package
has its counterpart file in the port (the two Pallas files map to the
port's kernel wrappers), and DataSet interchange (`utils/interop.py`) of
bfloat16 data.

NOT_YET_PORTED lists names still to be ported, with their ROADMAP item;
it is empty: the port has every module of the JAX package. The walk
checks each listed name is still missing, so the list can only shrink.
"""

from __future__ import annotations

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "deeplearning4j_tpu"

#: package -> {name: ROADMAP Queue 1 item that brings it}
NOT_YET_PORTED: dict = {}

#: JAX files whose counterpart in the port has another name: the Pallas
#: kernels' wrappers, over the CUDA kernels in `csrc/`
RENAMED = {
    "attention/flash_pallas.py": "attention/flash.py",
    "attention/paged_pallas.py": "attention/paged.py",
}
PORT_PKG = REPO / "deeplearning4j_tpu_torch"


def _init_files():
    return sorted(JAX_PKG.rglob("__init__.py"))


def _imported_names(path):
    """The names a module binds by its top-level imports."""
    names = []
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Import):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
    return names


def _sub(path):
    rel = path.parent.relative_to(JAX_PKG)
    return ".".join(rel.parts)


@pytest.mark.parametrize("path", _init_files(), ids=_sub)
def test_every_jax_package_name_exists_on_the_port(path):
    sub = _sub(path)
    names = _imported_names(path)
    skip = NOT_YET_PORTED.get(sub, {})
    port_name = "deeplearning4j_tpu_torch" + ("." + sub if sub else "")
    if "*" in skip:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(port_name)
        return
    mod = importlib.import_module(port_name)
    missing = [n for n in names if n not in skip and not hasattr(mod, n)]
    assert not missing, f"{port_name} lacks {missing} ({path})"
    for name in skip:  # still to be ported: the list must stay true
        assert not hasattr(mod, name), \
            f"{port_name}.{name} exists now: drop it from NOT_YET_PORTED"


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                  if "__pycache__" not in p.parts)


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_jax_module_file_has_a_port_counterpart(rel):
    ported = PORT_PKG / RENAMED.get(rel, rel)
    assert ported.is_file(), f"deeplearning4j_tpu/{rel} has no counterpart"


def test_the_file_walk_sees_every_subpackage():
    mods = _jax_modules()
    assert len(mods) > 150
    assert {"compilecache/warmup.py", "scaleout/perform_nlp.py",
            "utils/jitcache.py", "attention/paged_pallas.py"} <= set(mods)
    assert all((PORT_PKG / r).is_file() for r in RENAMED.values())


def test_the_walk_covers_the_core_reexports():
    from deeplearning4j_tpu_torch import MultiLayerNetwork as top
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.multilayer import \
        MultiLayerNetwork as direct
    from deeplearning4j_tpu_torch.scaleout import (DistributedRuntime,
                                                   TrainingSupervisor)

    assert top is MultiLayerNetwork is direct
    assert DistributedRuntime.__module__.startswith(
        "deeplearning4j_tpu_torch.")
    assert TrainingSupervisor.__module__.startswith(
        "deeplearning4j_tpu_torch.")
    walked = {_sub(p) for p in _init_files()}
    assert {"", "nn", "ops", "serving", "utils", "models",
            "scaleout", "compilecache"} <= walked


# --------------------------------------------------------- bf16 interop
def _bf16_pair(seed=0):
    """The same bfloat16 values as a JAX DataSet and a port DataSet."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
    from deeplearning4j_tpu_torch.datasets.api import DataSet

    rng = np.random.RandomState(seed)
    f = rng.randn(5, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 2, 1, 1, 0]]
    jds = JDataSet(jnp.asarray(f, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16))
    ds = DataSet(torch.from_numpy(f).bfloat16(), torch.from_numpy(y).bfloat16())
    return jds, ds


def test_to_numpy_of_bfloat16_returns_jax_values_as_float32():
    from deeplearning4j_tpu.utils import interop as jinterop
    from deeplearning4j_tpu_torch.utils import interop

    jds, ds = _bf16_pair()
    jf, jy = jinterop.to_numpy(jds)
    f, y = interop.to_numpy(ds)
    assert str(jf.dtype) == "bfloat16"
    assert f.dtype == np.float32 and y.dtype == np.float32
    np.testing.assert_array_equal(f, jf.astype(np.float32))
    np.testing.assert_array_equal(y, jy.astype(np.float32))


def test_to_torch_of_bfloat16_keeps_dtype_and_jax_values():
    from deeplearning4j_tpu.utils import interop as jinterop
    from deeplearning4j_tpu_torch.utils import interop

    jds, ds = _bf16_pair(1)
    f, y = interop.to_torch(ds)
    assert f.dtype == torch.bfloat16 and f.device.type == "cpu"
    np.testing.assert_array_equal(
        f.float().numpy(),
        jinterop.to_numpy(jds)[0].astype(np.float32))
    np.testing.assert_array_equal(
        y.float().numpy(),
        jinterop.to_numpy(jds)[1].astype(np.float32))
    # and back: from_torch of bf16 tensors
    back = interop.from_torch(f.float(), y.float())
    np.testing.assert_array_equal(back.features, f.float().numpy())


def test_to_device_of_bfloat16_matches_to_jax():
    from deeplearning4j_tpu.utils import interop as jinterop
    from deeplearning4j_tpu_torch.utils import interop

    jds, ds = _bf16_pair(2)
    jf, jy = jinterop.to_jax(jds)
    f, y = interop.to_device(ds, "cpu")
    assert f.dtype == torch.bfloat16 and y.dtype == torch.bfloat16
    np.testing.assert_array_equal(f.float().numpy(),
                                  np.asarray(jf, np.float32))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(jy, np.float32))
    # a numpy DataSet of the widened values goes the same way
    from deeplearning4j_tpu_torch.datasets.api import DataSet
    f2, _ = interop.to_device(DataSet(*interop.to_numpy(ds)), "cpu")
    assert f2.dtype == torch.float32
    np.testing.assert_array_equal(f2.numpy(), f.float().numpy())


def test_labeled_points_of_bfloat16_match_jax():
    from deeplearning4j_tpu.utils import interop as jinterop
    from deeplearning4j_tpu_torch.utils import interop

    jds, ds = _bf16_pair(3)
    ours = interop.to_labeled_points(ds)
    theirs = jinterop.to_labeled_points(jds)
    assert [p[0] for p in ours] == [p[0] for p in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
