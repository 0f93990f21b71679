"""The JAX package's numpy-only data layer, reused as it is.

rpagp/utils/datasets.py and rpagp/utils/native.py import nothing of JAX,
but importing them as `rpagp.utils.*` would run rpagp/__init__.py, which
imports jax. So rpagp/utils/ is loaded here as a package under another
name, from its files; the rest of rpagp is never imported.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_NAME = "_rpagp_np_utils"
_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                    "rpagp", "utils")


def _load():
    if _NAME + ".datasets" in sys.modules:
        return sys.modules[_NAME + ".datasets"]
    pkg_spec = importlib.util.spec_from_file_location(
        _NAME, os.path.join(_DIR, "__init__.py"),
        submodule_search_locations=[_DIR])
    pkg = importlib.util.module_from_spec(pkg_spec)
    sys.modules[_NAME] = pkg
    pkg_spec.loader.exec_module(pkg)
    return importlib.import_module(_NAME + ".datasets")


_ds = _load()
Dataset, Split = _ds.Dataset, _ds.Split
load_dataset, kfold_splits = _ds.load_dataset, _ds.kfold_splits
