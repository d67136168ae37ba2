"""Build and load the port's CUDA kernels.

At first use, nvcc compiles every ``.cu`` source under ``csrc/``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which ctypes loads. The library
lands in ``realtimedepthdiffusion_tpu_torch/build/``, named by a hash of the
sources and flags, so an edit to a kernel rebuilds it and an unchanged tree
reuses it; ``utils/cache.py`` can point it elsewhere (``use_build_dir``).
Importing this module runs nothing: a machine without nvcc can import the
package and run the plain versions.

No ``--use_fast_math``: it implies flush-to-zero and the approximate divide,
and the kernels must equal their plain versions bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
DEFAULT_BUILD_DIR = PKG_DIR / "build"
BUILD_DIR = DEFAULT_BUILD_DIR

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # ptxas reports each kernel's registers, shared memory and spills.
    "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int

# C entry points and their argument types: pointers and the stream as
# c_void_p (ctypes would otherwise pass a Python int as a 32-bit int and cut
# the pointer), ints as c_int. Each returns cudaGetLastError() as an int.
SIGNATURES = {
    # u_in, p_in, u_out, p_out, bh, bv, inv, mask, abc, nb, h, w, base,
    # n_active, k, bx, by, rows_per_thread, stop, stream
    "jc_sweep_tiles": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P, P),
    # u, p (in/out), bh, bv, inv, mask, abc, h, w, base, n, cluster,
    # sweeps per exchange, rows_per_thread, stop, stream
    "jc_sweep_resident": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P),
    # h, w, cluster, sweeps per exchange, rows_per_thread
    "jc_resident_check": (I, I, I, I, I),
    # int* out
    "jc_resident_max_cluster": (ctypes.POINTER(I),),
    # u_in, u_out, bh, bv, inv, mask, om, nb, h, w, base, n_active, k, bx,
    # by, rows, cols, parity_bits (64 bits, one per plane), stop, stream
    "rb_sweep_tiles": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, ctypes.c_uint64, P,
                       P),
    # u (in/out), bh, bv, inv, mask, om, h, w, base, n, bx, by, stop, stream
    "rb_sweep_resident": (P, P, P, P, P, P, I, I, I, I, I, I, P, P),
    # u_in, p_in, u_out, p_out, gray, mask, d8, abc, etab, h, w, base,
    # n_active, k, thr, use_depth_rule, bx, by, rows_per_thread, stop, stream
    "jc_sweep_fused": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P, P),
    # rgb, depth, half, sat, tot (scratch of the table route, else null),
    # out, h, w, k, max_half, approx, exact_upto, stride, tile (0: the table
    # route), stream
    "defocus_box": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, P),
    # chw_e, half, sat, tot (scratch of the table route, else null), out,
    # hb, wb, ring, oy, ox, full_h, full_w, max_half, tile, stream
    "defocus_block": (P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    # u, wl, wr, wu, wd, inv, mask, h, w, n, c, tol, is_max, stop, done,
    # probes, partials, ticket, blocks, stream
    "residual_probe": (P, P, P, P, P, P, P, I, I, I, I, ctypes.c_float, I, P, P, P, P, P, I, P),
    # e_in, e_out, rhs, bh, bv, inv, mask, h, w, n, k, stream
    "vc_smooth_tiles": (P, P, P, P, P, P, P, I, I, I, I, P),
    # e_in, e_out, rhs, bh, bv, inv, mask, h, w, n, stream
    "vc_smooth_resident": (P, P, P, P, P, P, P, I, I, I, P),
}

_lock = threading.Lock()
_lib = None
# What the build this process ran reported, if it ran one.
build_seconds = None
build_log = ""


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "cannot be built on this machine"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librtdd_kernels_{h.hexdigest()[:16]}.so"


def use_build_dir(path) -> Path:
    """Build into, and load from, ``path`` from the next ``load_library``
    of a process that has not loaded the library yet; returns it."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = Path(path)
        return BUILD_DIR


def _run_all(cmds, jobs: int | None = None) -> str:
    """Run the commands side by side, at most ``jobs`` at once (all of them
    if None), wait for every one, and raise with the stderr of the first
    that failed; returns their stderr."""
    step = len(cmds) if jobs is None else max(int(jobs), 1)
    errs = []
    for lo in range(0, len(cmds), step):
        wave = cmds[lo:lo + step]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in wave]
        outs = [p.communicate()[1] for p in procs]
        for cmd, proc, err in zip(wave, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        errs += outs
    return "".join(errs)


def _compile(out: Path, jobs: int | None = None) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{out.stem}.{os.getpid()}"
    objs = {src: BUILD_DIR / f"{stem}.{src.stem}.o" for src in sorted(CSRC_DIR.glob("*.cu"))}
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in objs.items()], jobs)
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs.values())]])
    finally:
        for o in objs.values():
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = log


def load_library(jobs: int | None = None) -> ctypes.CDLL:
    """The kernels' library, built on first call if needed, by at most
    ``jobs`` nvcc processes at once (one per source if None)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path, jobs)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.rtdd_error_string.argtypes = [ctypes.c_int]
            lib.rtdd_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load_library().rtdd_error_string(err) or b"?"
        raise RuntimeError(f"{name}: CUDA error {err} ({msg.decode()})")
