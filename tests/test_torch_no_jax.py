"""The port stands alone: neither it nor chip_smoke.py imports JAX or the
JAX package, nor TensorFlow (the reference importer reads SavedModel
bundles without it; the extractor exporter takes the caller's Keras
model)."""

import ast
import glob
import subprocess
import sys

import pytest

PORT_FILES = sorted(glob.glob("cyclegan_tpu_torch/**/*.py", recursive=True))
FORBIDDEN = ("jax", "jaxlib", "cyclegan_tpu")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_files_found():
    assert "cyclegan_tpu_torch/apps/inference.py" in PORT_FILES


@pytest.mark.parametrize("path", [
    "cyclegan_tpu_torch/apps/server.py", "cyclegan_tpu_torch/apps/export.py",
    "cyclegan_tpu_torch/apps/evaluate.py", "cyclegan_tpu_torch/apps/flows.py",
    "cyclegan_tpu_torch/predict.py", "cyclegan_tpu_torch/data/manifest.py",
    "cyclegan_tpu_torch/utils/quality.py",
    "cyclegan_tpu_torch/utils/extractor.py",
    "cyclegan_tpu_torch/utils/jax_random.py"])
def test_serving_and_evaluation_modules_are_checked(path):
    """The serving and evaluation modules are among the files whose
    imports are read and which one process imports below."""
    assert path in PORT_FILES


@pytest.mark.parametrize("path", [
    "cyclegan_tpu_torch/parallel/__init__.py",
    "cyclegan_tpu_torch/parallel/mesh.py",
    "cyclegan_tpu_torch/parallel/spatial.py",
    "cyclegan_tpu_torch/parallel/launch.py",
    "cyclegan_tpu_torch/ops/spatialctx.py"])
def test_parallel_modules_are_checked(path):
    """The parallelism modules are among the files whose imports are read
    and which one process imports below."""
    assert path in PORT_FILES


@pytest.mark.parametrize("path", [
    "cyclegan_tpu_torch/apps/import_reference.py",
    "cyclegan_tpu_torch/utils/tensor_bundle.py"])
def test_import_modules_are_checked(path):
    """The reference importer and its bundle reader are among the files
    whose imports are read and which one process imports below."""
    assert path in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_no_forbidden_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"
        assert top != "tensorflow", f"{path} imports {name}"


def test_importing_the_port_loads_no_jax():
    modules = sorted({p[:-3].replace("/", ".").removesuffix(".__init__")
                      for p in PORT_FILES})
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN + ("tensorflow",)) + "]\n"
            + "print(len(sys.modules)); assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
