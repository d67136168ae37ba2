"""k-wide halo exchange between the slots of a mesh (port of ``realtimedepthdiffusion_tpu/parallel/halo.py``).

Each slot's block is extended by a k-wide ring of its neighbours' data:
the top halo is the up-neighbour's bottom k rows, the bottom halo the
down-neighbour's top k rows, the sides likewise, and the corners the
diagonal neighbours' corners, which is what exchanging rows first and then
the columns of the row-extended blocks gives. Slots on the image border get
zeros there, which is right because the weights at the image border are
zero. Exchanging a k-wide halo every k sweeps leaves the interior exact,
since each sweep spoils one more ring from the edge.

JAX moves the strips with ``ppermute`` over ICI; here each strip is copied
into the receiving slot's extended block (``extend_into``), which may be a
view of a stack that holds every block of a device, across devices where
the two slots live on different cards.
"""

from __future__ import annotations

from typing import Dict

import torch

from .mesh import Slot, SlotMesh


# Where each of the eight neighbours' strips lands in an extended block
# (rows, then columns, of the extended block, for an offset of -1, 0 or +1)
# and which part of the neighbour's block it is.
def _dst(d, k, n):
    return slice(0, k) if d < 0 else slice(k, k + n) if d == 0 else slice(k + n, None)


def _src(d, k):
    return slice(-k, None) if d < 0 else slice(None) if d == 0 else slice(0, k)


def extend_into(mesh: SlotMesh, blocks: Dict[Slot, torch.Tensor], k: int,
                out: Dict[Slot, torch.Tensor]) -> None:
    """Write every slot's (..., h, w) block, extended by a k-wide ring of its
    neighbours' data, into ``out[slot]`` (..., h+2k, w+2k), which may be a
    view of a larger stack: the block itself, its up/down/left/right
    neighbours' k nearest rows or columns, and its diagonal neighbours'
    k x k corners. A part whose neighbour is off the grid is not written:
    ``out`` holds zeros there, from its allocation on. A strip from a slot
    on another device is copied across."""
    h, w = blocks[mesh.home_slot].shape[-2:]
    if not 1 <= k <= min(h, w):
        raise ValueError(f"a {k}-wide halo does not fit {h}x{w} blocks")
    for (p, i, j), dst in out.items():
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                src = blocks.get((p, i + di, j + dj))
                if src is not None:
                    dst[..., _dst(di, k, h), _dst(dj, k, w)].copy_(
                        src[..., _src(di, k), _src(dj, k)], non_blocking=True)


def extend_with_halo(mesh: SlotMesh, blocks: Dict[Slot, torch.Tensor], k: int) -> Dict[Slot, torch.Tensor]:
    """Every slot's (..., h, w) block extended to (..., h+2k, w+2k) with its
    neighbours' data (``extend_into``), in new tensors. The spatial block is
    the last two axes; leading axes (a slot's local batch, channels) ride
    along, so one exchange serves them all. k may not exceed a block's
    height or width."""
    out = {s: b.new_zeros((*b.shape[:-2], b.shape[-2] + 2 * k, b.shape[-1] + 2 * k))
           for s, b in blocks.items()}
    extend_into(mesh, blocks, k, out)
    return out


def crop_halo(blocks: Dict[Slot, torch.Tensor], k: int) -> Dict[Slot, torch.Tensor]:
    """Drop the k-wide ring (last two axes) of every slot's block."""
    return {s: x[..., k:-k, k:-k] for s, x in blocks.items()}
