"""Test-and-drill support that ships IN the package (not under tests/):
the chaos fault-injection layer lives here because production modules
carry its injection points and spawned replica processes must be able
to import it (`DL4J_TPU_CHAOS` env activation, docs/FAULT_TOLERANCE.md).
"""

from deeplearning4j_tpu_torch.testing import chaos  # noqa: F401
