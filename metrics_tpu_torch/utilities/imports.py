"""Package-availability and version gates.

Counterpart of ``metrics_tpu/utilities/imports.py``: ``_module_available``
and ``_compare_version``. The JAX package's feature flags gate its JAX and
Flax versions; the port has no module that gates on a package, so it keeps
no flag until one does. Versions compare by their leading numeric release
parts, so no version-parsing package is needed.
"""
import re
from importlib import import_module
from importlib.util import find_spec
from typing import Callable, Tuple


def _module_available(module_path: str) -> bool:
    """Return ``True`` if the (possibly nested) module can be imported."""
    parts = module_path.split(".")
    try:
        for i in range(len(parts)):
            if find_spec(".".join(parts[: i + 1])) is None:
                return False
    except (AttributeError, ImportError, ModuleNotFoundError, ValueError):
        return False
    return True


def _release(version: str) -> Tuple[int, ...]:
    """``"2.13.0+cu126"`` -> ``(2, 13, 0)``."""
    match = re.match(r"\d+(\.\d+)*", str(version).strip())
    return tuple(int(p) for p in match.group(0).split(".")) if match else (0,)


def _compare_version(package: str, op: Callable, version: str) -> bool:
    """Compare an installed package's version against ``version`` with ``op``."""
    if not _module_available(package):
        return False
    try:
        pkg = import_module(package)
        installed = _release(getattr(pkg, "__version__", "0.0.0"))
    except (ModuleNotFoundError, ImportError, TypeError):
        return False
    want = _release(version)
    width = max(len(installed), len(want))
    return op(installed + (0,) * (width - len(installed)), want + (0,) * (width - len(want)))

