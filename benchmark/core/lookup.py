"""The files of the benchmark found by name.

A metric's reader is ``metrics/<name>.py``, or else the reader that its
dotted names share, ``metrics/<name up to the first dot>.py``. A cell's
driver and plain reference are found from its traffic mix's ``kind`` by the
same rule, in ``drivers/`` and ``reference/``: ``train.assign`` takes
``reference/train.assign.py`` where it exists and ``reference/train.py``
where not. So a new kind, cell or metric comes as new files only.
"""
from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path

# the benchmark's folder, where ``metrics/``, ``drivers/`` and ``reference/``
# lie
HERE = Path(__file__).resolve().parents[1]


def by_name(folder: Path, name: str) -> Path:
    """The file of ``name`` in ``folder``: ``<name>.py`` if it exists, or
    else the file that its dotted names share, ``<name up to the first
    dot>.py``. Raises with the paths it tried where neither exists."""
    tried = list(dict.fromkeys([folder / f"{name}.py",
                                folder / f"{name.split('.')[0]}.py"]))
    for path in tried:
        if path.exists():
            return path
    raise LookupError(f"no file for {name!r} in {folder}; tried "
                      + ", ".join(map(str, tried)))


_LOADED: dict = {}


def load_file(path: Path, package: str):
    """The module of the file ``path`` in ``package``, where its relative
    imports resolve. A file of the package's own folder whose name is a
    module name is imported as such, so that it is the module an import
    statement reaches; any other (a dotted file name, ``train.assign.py``,
    or a file outside the package) is loaded from the file once."""
    pkg = importlib.import_module(package)
    if ("." not in path.stem
            and path.parent.resolve() == Path(pkg.__path__[0]).resolve()):
        return importlib.import_module(f"{package}.{path.stem}")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"{package}.{path.stem.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def metric_file(name: str) -> Path:
    """The reader of metric ``name`` (``by_name`` in ``metrics/``)."""
    return by_name(HERE / "metrics", name)


def kind_file(kind: str, folder: str) -> Path:
    """The file of a traffic mix's ``kind`` in ``folder``: its driver
    (``drivers``) or its plain reference (``reference``)."""
    return by_name(HERE / folder, kind)


def kind_module(kind: str, folder: str):
    """The module of ``kind_file``: the cell's driver (``drivers``) or its
    plain reference (``reference``)."""
    return load_file(kind_file(kind, folder), f"benchmark.{folder}")
