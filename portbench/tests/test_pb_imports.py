"""The check on the run's own modules, and the reference's imports."""

import ast
import os

from portbench import harness


def test_port_passes():
    assert harness.forbidden_loaded(["bathymetric_gnn_tpu_torch",
                                     "bathymetric_gnn_tpu_torch.models.gnn",
                                     "torch", "numpy"]) == []


def test_jax_package_and_jax_fail():
    assert harness.forbidden_loaded(["bathymetric_gnn_tpu"]) == [
        "bathymetric_gnn_tpu"]
    assert harness.forbidden_loaded(["bathymetric_gnn_tpu.ops.features",
                                     "torch"]) == ["bathymetric_gnn_tpu"]
    assert harness.forbidden_loaded(["jax", "jax.numpy", "jaxlib.xla"]) == [
        "jax", "jaxlib"]
    assert harness.forbidden_loaded(["flax.linen", "optax", "orbax"]) == [
        "flax", "optax", "orbax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    """Plain torch and NumPy, and one another (relative imports)."""
    ref = os.path.join(harness.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for name in _imports(os.path.join(ref, f)):
                top = name.split(".")[0]
                assert top in ("torch", "numpy", "math", "contextlib",
                               "typing", "__future__"), (f, name)


def test_harness_imports_no_jax():
    for dirpath, _dirs, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                for name in _imports(os.path.join(dirpath, f)):
                    assert harness.forbidden_loaded([name]) == [], (f, name)
