"""The port stands alone: neither it nor chip_smoke.py imports JAX or the
JAX package."""

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


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_no_forbidden_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def test_importing_the_port_loads_no_jax():
    modules = sorted({p[:-3].replace("/", ".").removesuffix(".__init__")
                      for p in PORT_FILES})
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + "]\n"
            + "print(len(sys.modules)); assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
