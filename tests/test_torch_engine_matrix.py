"""The port's engine (device="cpu") returns the reference engine's rows, in
order, with join_backend="matrix"."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import torch  # noqa: F401
from test_torch_engine_default import backend_module_tests

engines, test_rows_equal_reference = backend_module_tests("matrix")
