"""The check that JAX stayed out of the process compares whole
top-level names, and the plain references import nothing of the
program."""

import ast
import subprocess
import sys

from harness import common


def test_whole_top_level_names():
    mods = {"deeplearning4j_tpu_torch": 1,
            "deeplearning4j_tpu_torch.serving": 1, "numpy": 1,
            "jaxtyping": 1, "flaxen": 1}
    assert common.forbidden_loaded(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "deeplearning4j_tpu", "deeplearning4j_tpu.nn"):
        assert common.forbidden_loaded({**mods, bad: 1}) == \
            [bad.split(".")[0]]


def test_reference_sources_import_nothing_of_the_program():
    for path in (common.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert not n.startswith("deeplearning4j_tpu"), (path, n)
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax")


def test_reference_loads_without_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.gpt2, reference.mlp; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('deeplearning4j') or m.split('.')[0] in "
            "('jax', 'flax')))" % str(common.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import harness.serve, harness.train_dp; "
            "from harness import common; print(common.forbidden_loaded())"
            % (str(common.BENCH_DIR), str(common.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
