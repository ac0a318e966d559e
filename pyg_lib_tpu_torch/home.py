"""Cache-directory handling (port of ``pyg_lib_tpu/home.py``; reference
``pyg_lib/home.py``).

``$PYG_LIB_TPU_HOME`` overrides the default ``~/.cache/pyg_lib_tpu``, the
JAX package's directory, so a dataset placed for one package is found by
the other; ``datasets.get_sparse_matrix`` reads from it.
"""

import os
import os.path as osp
from typing import Optional

__all__ = ['get_home_dir', 'set_home_dir']

ENV_PYG_LIB_TPU_HOME = 'PYG_LIB_TPU_HOME'
DEFAULT_CACHE_DIR = osp.join('~', '.cache', 'pyg_lib_tpu')

_home_dir: Optional[str] = None


def get_home_dir() -> str:
    """Cache directory, created on first use. Resolution order: prior
    :func:`set_home_dir` call, ``$PYG_LIB_TPU_HOME``, the default."""
    if _home_dir is not None:
        path = _home_dir
    else:
        path = os.getenv(ENV_PYG_LIB_TPU_HOME, DEFAULT_CACHE_DIR)
    path = osp.expanduser(path)
    os.makedirs(path, exist_ok=True)
    return path


def set_home_dir(path: str) -> None:
    """Overrides the cache directory for this process."""
    global _home_dir
    _home_dir = path
