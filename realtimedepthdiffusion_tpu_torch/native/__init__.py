"""The native host runtime: brush, annotation codec, planner, UI event
queue and host arena, in C++ built by g++ at first use, with a pure-Python
fallback for a machine without a toolchain."""

from .runtime import Arena, EventQueue, NativeRuntime

__all__ = ["Arena", "EventQueue", "NativeRuntime"]
