"""k-wide halo exchange between the slots of a mesh (port of ``realtimedepthdiffusion_tpu/parallel/halo.py``).

Each slot's block is extended by a k-wide ring of its neighbours' data:
rows first (the top halo is the up-neighbour's bottom k rows, the bottom
halo the down-neighbour's top k rows), then columns taken from the
row-extended neighbours, so the corners carry true diagonal data. Slots on
the image border get zeros there, which is right because the weights at
the image border are zero. Exchanging a k-wide halo every k sweeps leaves
the interior exact, since each sweep spoils one more ring from the edge.

JAX moves the strips with ``ppermute`` over ICI; here a strip moves to the
receiving slot's device with ``.to(device, non_blocking=True)``, a no-op
between slots of one device.
"""

from __future__ import annotations

from typing import Dict

import torch

from .mesh import Slot, SlotMesh


def _strip(blocks, src: Slot, take, like: torch.Tensor) -> torch.Tensor:
    """``take`` of the block of slot ``src`` on ``like``'s device, or zeros
    shaped as ``take(like)`` where ``src`` is off the grid."""
    block = blocks.get(src)
    if block is None:
        return torch.zeros_like(take(like))
    return take(block).to(like.device, non_blocking=True)


def extend_with_halo(mesh: SlotMesh, blocks: Dict[Slot, torch.Tensor], k: int) -> Dict[Slot, torch.Tensor]:
    """Every slot's (..., h, w) block extended to (..., h+2k, w+2k) with its
    neighbours' data. The spatial block is the last two axes; leading axes
    (a slot's local batch, channels) ride along, so one exchange serves
    them all. k may not exceed a block's height or width."""
    h, w = blocks[mesh.home_slot].shape[-2:]
    if not 1 <= k <= min(h, w):
        raise ValueError(f"a {k}-wide halo does not fit {h}x{w} blocks")
    rows = {}
    for p, i, j in mesh.slots:
        x = blocks[(p, i, j)]
        top = _strip(blocks, (p, i - 1, j), lambda a: a[..., -k:, :], x)
        bot = _strip(blocks, (p, i + 1, j), lambda a: a[..., :k, :], x)
        rows[(p, i, j)] = torch.cat([top, x, bot], dim=-2)
    out = {}
    for p, i, j in mesh.slots:
        xv = rows[(p, i, j)]
        left = _strip(rows, (p, i, j - 1), lambda a: a[..., :, -k:], xv)
        right = _strip(rows, (p, i, j + 1), lambda a: a[..., :, :k], xv)
        out[(p, i, j)] = torch.cat([left, xv, right], dim=-1)
    return out


def crop_halo(blocks: Dict[Slot, torch.Tensor], k: int) -> Dict[Slot, torch.Tensor]:
    """Drop the k-wide ring (last two axes) of every slot's block."""
    return {s: x[..., k:-k, k:-k] for s, x in blocks.items()}
