"""The port runs on a GPU host that has no JAX, PIL, scikit-learn, OpenCV or
h5py.

Walks the AST of every module of ``contrastive_lift_tpu_torch`` and of
``chip_smoke.py`` and fails on any import of ``jax``, of the JAX package
``contrastive_lift_tpu`` (the port keeps its own copies even of its JAX-free
modules), of ``PIL``, of ``sklearn`` or of ``cv2``, wherever in the file it
appears; ``h5py`` only inside ``preprocess_hypersim``, as in the JAX
package.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "contrastive_lift_tpu", "PIL", "sklearn", "cv2")
# (module, function) that alone may import h5py
H5PY_ONLY_IN = ("contrastive_lift_tpu_torch/data/preprocessing/hypersim.py",
                "preprocess_hypersim")
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


def _h5py_importers(tree):
    """The names of the functions an ``import h5py`` sits in (``None``: at
    module level)."""
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func)
            if any(m and m.split(".")[0] == "h5py"
                   for m in _imported_modules(ast.Module(body=[child],
                                                         type_ignores=[]))
                   ) and isinstance(child, (ast.Import, ast.ImportFrom)):
                found.append(func)
            visit(child, inner)
    visit(tree, None)
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_h5py_only_in_hypersim(path):
    """h5py (absent on the card's machine) is imported only lazily, inside
    the HyperSim script."""
    where = _h5py_importers(ast.parse(path.read_text(), filename=str(path)))
    rel = path.relative_to(ROOT).as_posix()
    allowed = [H5PY_ONLY_IN[1]] if rel == H5PY_ONLY_IN[0] else []
    assert all(f in allowed for f in where), f"{rel} imports h5py in {where}"


def test_rule_catches_what_it_should():
    src = ("import jax.numpy as jnp\nfrom contrastive_lift_tpu.config import Config\n"
           "def f():\n    from PIL import Image\n    import sklearn.cluster\n"
           "from contrastive_lift_tpu_torch.config import Config\nimport torch\n"
           "import cv2\n")
    bad = [m for m in _imported_modules(ast.parse(src)) if _forbidden(m)]
    assert sorted(bad) == sorted(["jax.numpy", "contrastive_lift_tpu.config",
                                  "PIL", "sklearn.cluster", "cv2"])
    h5 = ("import h5py\ndef preprocess_hypersim():\n    import h5py\n"
          "def other():\n    if True:\n        from h5py import File\n")
    assert _h5py_importers(ast.parse(h5)) == [None, "preprocess_hypersim",
                                              "other"]


def test_package_has_modules_to_check():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "contrastive_lift_tpu_torch/ops/brick_interp.py",
            "contrastive_lift_tpu_torch/renderer/render.py",
            H5PY_ONLY_IN[0]} <= names
