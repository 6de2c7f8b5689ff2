"""Where the engine's CUDA kernels are built: `tpu.compile_cache`.

Port of symmetry_tpu/utils/compile_cache.py. The JAX package points XLA's
persistent compilation cache at a directory so that a restart does not
recompile the serving grid. The port runs eagerly and compiles nothing but
its CUDA kernels (ops/kernels.py: nvcc over the csrc/ sources, libraries
named by a hash of their source), so its cache is the directory those
libraries are built into and loaded from:

  - True (the provider's default): build/torch_kernels/ at the repository
    root, shared by every process, so a restart loads the libraries at
    once;
  - a string: that directory;
  - False: a fresh directory for this process, removed when it exits, so
    every start builds the kernels anew.

A directory that cannot be written raises, naming the path: nothing falls
back to another directory in silence.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Any

from symmetry_tpu_torch.ops import kernels


def enable_compile_cache(tpu_cfg: Any = None) -> str:
    """Point the kernel build at the directory `tpu_cfg.compile_cache`
    names (see the module docstring) and return it. Call before the first
    kernel builds (the host calls it at start, before the engine's
    warmup). Raises OSError naming the directory when it cannot be
    created or written."""
    setting = True if tpu_cfg is None else getattr(tpu_cfg, "compile_cache",
                                                   True)
    if setting is False:
        path = tempfile.mkdtemp(prefix="symmetry_torch_kernels_")
        atexit.register(shutil.rmtree, path, ignore_errors=True)
    elif isinstance(setting, str):
        path = os.path.abspath(os.path.expanduser(setting))
    else:
        path = str(kernels.DEFAULT_BUILD_DIR)
    try:
        os.makedirs(path, exist_ok=True)
        with tempfile.TemporaryFile(dir=path):
            pass
    except OSError as exc:
        raise OSError(f"tpu.compile_cache: cannot write the kernel build "
                      f"directory {path}: {exc}") from exc
    kernels.set_build_dir(path)
    return path
