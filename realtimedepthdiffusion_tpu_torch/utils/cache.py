"""The build cache of the port's kernels (twin of
``realtimedepthdiffusion_tpu/utils/cache.py``).

The JAX package keeps XLA's persistent compilation cache here. Eager torch
compiles nothing ahead: what persists across processes on the card is the
nvcc build of ``csrc/`` (``ops/build.py``: one shared library named by a
hash of the sources and flags). This module says where it lands: the
package's ``build/`` by default, ``RTDD_CACHE_DIR`` where that is set.
With ``RTDD_NO_COMPILE_CACHE=1`` the process builds into a directory of its
own. Nothing here falls back: a build that fails raises with nvcc's stderr.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

from ..ops import build


def default_cache_dir() -> str:
    env = os.environ.get("RTDD_CACHE_DIR")
    if env:
        return env
    return str(build.DEFAULT_BUILD_DIR)


def enable_compilation_cache(cache_dir: str | None = None) -> str | None:
    """Point ``ops/build.py`` at the build cache; returns the directory, or
    None when ``RTDD_NO_COMPILE_CACHE`` turns it off (the build then goes
    to a directory of this process, removed at its exit)."""
    if os.environ.get("RTDD_NO_COMPILE_CACHE", "").lower() not in ("", "0", "false"):
        own = tempfile.mkdtemp(prefix="rtdd-kernels-")
        atexit.register(shutil.rmtree, own, True)
        build.use_build_dir(own)
        return None
    cache = cache_dir or default_cache_dir()
    os.makedirs(cache, exist_ok=True)
    build.use_build_dir(cache)
    return cache
