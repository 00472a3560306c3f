"""The port runs on a GPU host that has no JAX, PIL or scikit-learn.

Walks the AST of every module of ``contrastive_lift_tpu_torch`` and of
``chip_smoke.py`` and fails on any import of ``jax``, of the JAX package
``contrastive_lift_tpu`` (the port keeps its own copies even of its JAX-free
modules), of ``PIL`` or of ``sklearn``, wherever in the file it appears.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "contrastive_lift_tpu", "PIL", "sklearn")
PACKAGE = ROOT / "contrastive_lift_tpu_torch"
# _build/ holds what the kernels' build writes, not sources of the package
FILES = sorted(p for p in PACKAGE.rglob("*.py")
               if "_build" not in p.relative_to(PACKAGE).parts) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_rule_catches_what_it_should():
    src = ("import jax.numpy as jnp\nfrom contrastive_lift_tpu.config import Config\n"
           "def f():\n    from PIL import Image\n    import sklearn.cluster\n"
           "from contrastive_lift_tpu_torch.config import Config\nimport torch\n")
    bad = [m for m in _imported_modules(ast.parse(src)) if _forbidden(m)]
    assert bad == ["jax.numpy", "contrastive_lift_tpu.config", "PIL",
                   "sklearn.cluster"]


def test_package_has_modules_to_check():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "contrastive_lift_tpu_torch/ops/brick_interp.py",
            "contrastive_lift_tpu_torch/renderer/render.py"} <= names
