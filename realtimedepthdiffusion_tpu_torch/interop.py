"""Carrying state between the JAX package and the port.

Everything crosses as numpy arrays, so neither package imports the other:
a JAX caller hands over ``np.asarray`` of its arrays, and takes back what
the ``*_to_numpy`` functions return.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from .config import DiffusionConfig


def config_from_dict(d: dict) -> DiffusionConfig:
    """A port config from ``dataclasses.asdict`` of a JAX ``DiffusionConfig``.

    Unknown keys raise, so a field added on one side only is caught here.
    """
    names = {f.name for f in dataclasses.fields(DiffusionConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown DiffusionConfig fields: {unknown}")
    return DiffusionConfig(**d)


def _to_device(arrays: Sequence[np.ndarray], dtype, device) -> Tuple[torch.Tensor, ...]:
    # np.array copies: a JAX array's numpy view is read-only, and torch
    # does not take read-only memory.
    return tuple(torch.from_numpy(np.array(a)).to(device=device, dtype=dtype) for a in arrays)


def _to_numpy(tensors: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    return tuple(t.detach().cpu().numpy() for t in tensors)


def state_from_numpy(levels: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, ...]:
    """Depth-state pyramid (finest first) as float32 tensors on ``device``."""
    return _to_device(levels, torch.float32, device)


def state_to_numpy(state: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    """Depth-state pyramid as float32 numpy arrays (finest first)."""
    return _to_numpy(state)


def gray_pyramid_from_numpy(levels: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, ...]:
    """Gray pyramid (finest first) as uint8 tensors on ``device``."""
    return _to_device(levels, torch.uint8, device)


def gray_pyramid_to_numpy(gray_pyr: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    return _to_numpy(gray_pyr)


def annotation_from_numpy(mask: np.ndarray, value: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Annotation planes: (bool mask, uint8 value) tensors on ``device``."""
    (m,) = _to_device([mask], torch.bool, device)
    (v,) = _to_device([value], torch.uint8, device)
    return m, v


def annotation_to_numpy(mask: torch.Tensor, value: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    return _to_numpy([mask, value])
