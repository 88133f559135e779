"""Nothing under benchmark/ imports JAX or the JAX package, compared by
the whole top-level name (the program's name begins with the JAX
package's); the plain reference imports nothing of the program either."""

import ast
import glob
import sys
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
FILES = sorted(glob.glob(str(ROOT / "benchmark" / "**" / "*.py"),
                         recursive=True))
FORBIDDEN = {"jax", "jaxlib", "flax", "cyclegan_tpu"}


def top_level_imports(path):
    tree = ast.parse(Path(path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_files_found():
    names = {Path(f).relative_to(ROOT).as_posix() for f in FILES}
    assert {"benchmark/run.py", "benchmark/reference/nets.py",
            "benchmark/drivers/train.py"} <= names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: Path(p).relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [f for f in FILES if "/reference/" in f],
                         ids=lambda p: Path(p).relative_to(ROOT).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    assert "cyclegan_tpu_torch" not in set(top_level_imports(path))


def test_the_whole_name_is_compared(monkeypatch):
    """cyclegan_tpu_torch is allowed, cyclegan_tpu and jax are not."""
    monkeypatch.setitem(sys.modules, "cyclegan_tpu_torch_lookalike",
                        type(sys)("x"))
    assert "cyclegan_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cyclegan_tpu.models", type(sys)("x"))
    assert run.forbidden_modules() == ["cyclegan_tpu"]
    monkeypatch.setitem(sys.modules, "jax", type(sys)("x"))
    assert run.forbidden_modules() == ["cyclegan_tpu", "jax"]
