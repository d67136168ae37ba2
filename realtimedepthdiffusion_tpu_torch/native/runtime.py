"""ctypes binding for the native host runtime (port of ``realtimedepthdiffusion_tpu/native/runtime.py``).

Builds the shared library from ``src/rtdd_runtime.cpp`` on first use with
g++ (a plain C ABI, no pybind11) into ``build/librtdd_runtime_torch.so``.
The name differs from the JAX package's library, so a process that loads
both packages holds two libraries, not one under two names. Every entry
point has a pure-Python fallback so the port works without a toolchain;
``NativeRuntime.available`` reports which path is active. The library runs
on the host: brush strokes, the annotation codec and the UI event queue
never touch the device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "rtdd_runtime.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD_DIR, "librtdd_runtime_torch.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if not (os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        # Several processes may build at once (test workers): each writes
        # its own file and renames it into place, so none loads a library
        # that another is still writing.
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
            _SRC, "-o", tmp,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.remove(tmp)
            _build_failed = True
            return None
    lib = ctypes.CDLL(_SO)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rtdd_plan.restype = ctypes.c_int
    lib.rtdd_plan.argtypes = [ctypes.c_int] * 4 + [i32p, i32p, i32p, ctypes.c_int]
    lib.rtdd_chebyshev_omegas.restype = None
    lib.rtdd_chebyshev_omegas.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float, f32p]
    lib.rtdd_paint.restype = ctypes.c_int
    lib.rtdd_paint.argtypes = [u8p, u8p] + [ctypes.c_int] * 6 + [i32p]
    lib.rtdd_annotation_decode.restype = None
    lib.rtdd_annotation_decode.argtypes = [u8p, ctypes.c_int, ctypes.c_uint8, u8p, u8p]
    lib.rtdd_annotation_encode.restype = None
    lib.rtdd_annotation_encode.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_uint8, u8p]
    lib.rtdd_queue_create.restype = ctypes.c_void_p
    lib.rtdd_queue_create.argtypes = [ctypes.c_uint32]
    lib.rtdd_queue_destroy.restype = None
    lib.rtdd_queue_destroy.argtypes = [ctypes.c_void_p]
    lib.rtdd_queue_push.restype = ctypes.c_int
    lib.rtdd_queue_push.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    lib.rtdd_queue_pop.restype = ctypes.c_int
    lib.rtdd_queue_pop.argtypes = [ctypes.c_void_p, i32p]
    lib.rtdd_queue_size.restype = ctypes.c_int
    lib.rtdd_queue_size.argtypes = [ctypes.c_void_p]
    lib.rtdd_arena_create.restype = ctypes.c_void_p
    lib.rtdd_arena_create.argtypes = [ctypes.c_size_t]
    lib.rtdd_arena_alloc.restype = ctypes.c_void_p
    lib.rtdd_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t]
    lib.rtdd_arena_reset.restype = None
    lib.rtdd_arena_reset.argtypes = [ctypes.c_void_p]
    lib.rtdd_arena_used.restype = ctypes.c_size_t
    lib.rtdd_arena_used.argtypes = [ctypes.c_void_p]
    lib.rtdd_arena_destroy.restype = None
    lib.rtdd_arena_destroy.argtypes = [ctypes.c_void_p]
    lib.rtdd_version.restype = ctypes.c_int
    lib.rtdd_version.argtypes = []
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None and not _build_failed:
            _lib = _build()
        return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeRuntime:
    """High-level facade; falls back to NumPy when the .so is unavailable."""

    def __init__(self) -> None:
        self.lib = get_lib()

    @property
    def available(self) -> bool:
        return self.lib is not None

    # -- planner ----------------------------------------------------------
    def plan(self, rows: int, cols: int, base_size: int, max_iterations: int):
        if self.lib is not None:
            n = 32
            lr = (ctypes.c_int32 * n)()
            lc = (ctypes.c_int32 * n)()
            li = (ctypes.c_int32 * n)()
            levels = self.lib.rtdd_plan(rows, cols, base_size, max_iterations,
                                        lr, lc, li, n)
            return [(lr[i], lc[i], li[i]) for i in range(levels)]
        import math

        q = max(min(rows, cols) // base_size, 1)
        levels = int(math.log2(q)) + 1
        return [
            (rows >> l, cols >> l,
             int(max_iterations / 2.0 ** (levels - 1 - l)))
            for l in range(levels)
        ]

    def chebyshev_omegas(self, iters: int, s: int, rho: float) -> np.ndarray:
        if self.lib is not None:
            out = np.empty(iters, dtype=np.float32)
            self.lib.rtdd_chebyshev_omegas(
                iters, s, ctypes.c_float(rho),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out
        from ..config import DiffusionConfig
        from ..core.solver import chebyshev_omegas

        return chebyshev_omegas(iters, DiffusionConfig(chebyshev_s=s, chebyshev_rho=rho))

    # -- brush ------------------------------------------------------------
    def paint(self, mask: np.ndarray, value: np.ndarray, x: int, y: int,
              color: int, radius: int) -> Optional[Tuple[int, int, int, int]]:
        """In-place square-brush paint; returns the dirty rect (y0,x0,y1,x1)
        or None if nothing was painted. mask is uint8 0/1."""
        if not (mask.flags.c_contiguous and value.flags.c_contiguous
                and mask.dtype == np.uint8 and value.dtype == np.uint8
                and mask.shape == value.shape and mask.ndim == 2):
            raise ValueError("paint takes two C-contiguous uint8 planes of one (H, W) shape")
        if self.lib is not None:
            rect = (ctypes.c_int32 * 4)()
            ok = self.lib.rtdd_paint(_u8p(mask), _u8p(value),
                                     mask.shape[0], mask.shape[1],
                                     x, y, color, radius, rect)
            return tuple(rect) if ok else None
        h, w = mask.shape
        half = max(radius, 0) // 2
        y0, y1 = max(y - half, 0), min(y + half, h - 1)
        x0, x1 = max(x - half, 0), min(x + half, w - 1)
        if y0 > y1 or x0 > x1:
            return None
        mask[y0 : y1 + 1, x0 : x1 + 1] = 1
        value[y0 : y1 + 1, x0 : x1 + 1] = np.uint8(color)
        return (y0, x0, y1, x1)

    # -- annotation codec ---------------------------------------------------
    def annotation_decode(self, plane: np.ndarray, sentinel: int):
        plane = np.ascontiguousarray(plane, dtype=np.uint8)
        if self.lib is not None:
            mask = np.empty_like(plane)
            value = np.empty_like(plane)
            self.lib.rtdd_annotation_decode(_u8p(plane), plane.size,
                                            sentinel, _u8p(mask), _u8p(value))
            return mask.astype(bool), value
        mask = plane != np.uint8(sentinel)
        return mask, np.where(mask, plane, 0).astype(np.uint8)

    def annotation_encode(self, mask: np.ndarray, value: np.ndarray, sentinel: int):
        m = np.ascontiguousarray(mask, dtype=np.uint8)
        v = np.ascontiguousarray(value, dtype=np.uint8)
        if m.shape != v.shape:
            raise ValueError(f"annotation_encode: mask {m.shape} and value {v.shape} differ")
        if self.lib is not None:
            out = np.empty_like(v)
            self.lib.rtdd_annotation_encode(_u8p(m), _u8p(v), v.size, sentinel, _u8p(out))
            return out
        return np.where(m != 0, v, np.uint8(sentinel)).astype(np.uint8)


class Arena:
    """Bump allocator for a session's host-side frame buffers (native
    rtdd_arena_*), with a plain-NumPy fallback.

    Buffers returned by :meth:`alloc_u8` are NumPy views into the arena and
    stay valid until :meth:`close` — the owning session must outlive them.
    One arena serves one session: annotation planes + display compositing
    buffers come from a single contiguous, 64-byte-aligned slab instead of
    scattered allocator churn. A tensor made with ``torch.from_numpy`` of a
    view shares the arena's memory, so copy before the planes are painted
    again.
    """

    def __init__(self, capacity_bytes: int) -> None:
        self.lib = get_lib()
        self.capacity = int(capacity_bytes)
        self._a = (
            self.lib.rtdd_arena_create(self.capacity) if self.lib is not None else None
        )
        self._fallback_used = 0

    @property
    def native(self) -> bool:
        return self._a is not None

    def alloc_u8(self, shape, align: int = 64) -> np.ndarray:
        """Zero-initialized uint8 array carved from the arena."""
        n = int(np.prod(shape))
        if self._a is not None:
            ptr = self.lib.rtdd_arena_alloc(self._a, n, align)
            if ptr:
                flat = np.ctypeslib.as_array(
                    ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), (n,)
                )
                arr = flat.reshape(shape)
                arr.fill(0)
                return arr
            # capacity exhausted: fall through to a heap allocation
        self._fallback_used += n
        return np.zeros(shape, dtype=np.uint8)

    @property
    def used(self) -> int:
        if self._a is not None:
            return int(self.lib.rtdd_arena_used(self._a)) + self._fallback_used
        return self._fallback_used

    def close(self) -> None:
        if self._a is not None:
            self.lib.rtdd_arena_destroy(self._a)
            self._a = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class EventQueue:
    """MPSC UI-event ring buffer (native), with a deque fallback.

    Event kinds: PAINT from the mouse-callback thread (a,b = x,y), KEY from
    the UI tick (a = key byte). All UI events flow through this one queue and
    are drained on the solve-loop thread (live/gui.py)."""

    KIND_PAINT, KIND_KEY = 0, 1

    def __init__(self, capacity: int = 1024) -> None:
        self.lib = get_lib()
        self._closed = False
        # Guards the closed-check/native-call pairs: close() may race a
        # push() from OpenCV's mouse-callback thread during GUI shutdown;
        # without the lock that is a use-after-free on the destroyed queue.
        self._state_lock = threading.Lock()
        if self.lib is not None:
            self._q = self.lib.rtdd_queue_create(capacity)
            self._deque = None
        else:
            import collections

            self._q = None
            self._deque = collections.deque(maxlen=capacity)

    def push(self, kind: int, a: int = 0, b: int = 0, c: int = 0) -> bool:
        # After close() events are dropped (the GUI's mouse-callback thread
        # can still fire during shutdown).
        with self._state_lock:
            if self._closed:
                return False
            if self._q is not None:
                return bool(self.lib.rtdd_queue_push(self._q, kind, a, b, c))
            self._deque.append((kind, a, b, c))
            return True

    def pop(self):
        with self._state_lock:
            if self._closed:
                return None
            if self._q is not None:
                out = (ctypes.c_int32 * 4)()
                if self.lib.rtdd_queue_pop(self._q, out):
                    return tuple(out)
                return None
            try:
                return self._deque.popleft()
            except IndexError:
                return None

    def __len__(self) -> int:
        with self._state_lock:
            if self._closed:
                return 0
            if self._q is not None:
                return self.lib.rtdd_queue_size(self._q)
            return len(self._deque)

    def close(self) -> None:
        with self._state_lock:
            self._closed = True
            if self._q is not None:
                self.lib.rtdd_queue_destroy(self._q)
                self._q = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
