"""The pure-NumPy reference: the semantic ground truth the port's solves
are held to, on any machine that has numpy."""

from . import numpy_ref

__all__ = ["numpy_ref"]
