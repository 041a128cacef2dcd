"""The port stands alone: no module of physher_tpu_torch, and neither
chip_smoke.py nor chip_profile.py, imports jax or anything of the JAX package physher_tpu (a
machine with the card has no jax). Each file is parsed, not imported, so
that a conditional or late import counts too."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "physher_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "chip_profile.py"]
FORBIDDEN = ("jax", "jaxlib", "physher_tpu")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES)
def test_no_jax_imports(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_the_check_catches_a_jax_import():
    tree = ast.parse("import numpy\nfrom jax import numpy as jnp\n"
                     "import physher_tpu.models.coalescent\n"
                     "from physher_tpu_torch.ops import staged\n"
                     "def f():\n    import jax.numpy\n")
    assert [m for m in _imported_modules(tree) if _forbidden(m)] == [
        "jax", "physher_tpu.models.coalescent", "jax.numpy"]
    assert len(FILES) > 30
