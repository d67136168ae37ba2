"""The slot mesh of the sharded step (port of ``realtimedepthdiffusion_tpu/parallel/mesh.py``).

JAX runs the multi-device step as one program over a ('batch', 'dy', 'dx')
``Mesh`` of devices. Here one process owns a mesh of *slots* of the same
three axes: 'batch' splits a batch of images, ('dy', 'dx') split each image
into a grid of blocks, and each slot holds its blocks on one
``torch.device``. With one card every slot lives on it, the counterpart of
JAX's virtual CPU mesh; with several, slots go round-robin over the cards
and the halo strips cross between them as device-to-device copies; in the
CPU tests every slot is on the CPU.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Slot = Tuple[int, int, int]


def factor3(n: int) -> Tuple[int, int, int]:
    """Factor n devices into (batch, dy, dx), preferring spatial axes and
    near-square spatial tiles: 8 -> (2,2,2), 4 -> (1,2,2), 2 -> (1,1,2),
    1 -> (1,1,1), 6 -> (1,2,3)... Any composite n is supported."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")

    def best_2d(m: int) -> Tuple[int, int]:
        a = int(np.sqrt(m))
        while a > 1 and m % a:
            a -= 1
        return (max(a, 1), m // max(a, 1))

    dy, dx = best_2d(n)
    if dy > 1:  # peel a batch factor when the spatial grid is >= 2x2
        if n % 8 == 0:
            b = 2
            dy, dx = best_2d(n // 2)
            return b, dy, dx
    return 1, dy, dx


class SlotMesh:
    """A (batch, dy, dx) grid of slots, each with its ``torch.device``.

    ``shape`` is ``{"batch": b, "dy": dy, "dx": dx}`` as on a JAX ``Mesh``;
    ``home`` is slot (0, 0, 0)'s device, where global tensors live.
    """

    def __init__(self, devices: Dict[Slot, torch.device], shape: Tuple[int, int, int]):
        self.devices = devices
        self.shape = dict(zip(("batch", "dy", "dx"), shape))
        self.home_slot = (0, 0, 0)
        self.home = devices[self.home_slot]

    @property
    def slots(self):
        return list(self.devices)

    def __repr__(self) -> str:
        return f"SlotMesh({self.shape}, devices={sorted({str(d) for d in self.devices.values()})})"

    def batch_row(self, p: int) -> "SlotMesh":
        """The (1, dy, dx) mesh of the slots of batch index ``p``."""
        row = {(0, i, j): dev for (q, i, j), dev in self.devices.items() if q == p}
        return SlotMesh(row, (1, self.shape["dy"], self.shape["dx"]))

    def scatter(self, x: torch.Tensor) -> Dict[Slot, torch.Tensor]:
        """Split a padded global (B, H, W) or (B, C, H, W) tensor into one
        contiguous block per slot, on the slot's device: slot (p, i, j)
        takes images p*B/b .. and the (H/dy, W/dx) block (i, j). The
        dimensions must divide by the mesh's."""
        b, dy, dx = self.shape["batch"], self.shape["dy"], self.shape["dx"]
        n, h, w = x.shape[0], x.shape[-2], x.shape[-1]
        if n % b or h % dy or w % dx:
            raise ValueError(f"a {tuple(x.shape)} tensor does not split over mesh {self.shape}")
        nb, hb, wb = n // b, h // dy, w // dx
        return {
            (p, i, j): x[p * nb:(p + 1) * nb, ..., i * hb:(i + 1) * hb, j * wb:(j + 1) * wb]
            .to(dev, non_blocking=True).contiguous()
            for (p, i, j), dev in self.devices.items()
        }

    def gather(self, blocks: Dict[Slot, torch.Tensor], y_axis: int = -2) -> torch.Tensor:
        """The inverse of ``scatter``, on the home device. Each block's rows
        lie on ``y_axis`` and its columns on the axis after it, so a
        (B, h, w, 3) block passes ``y_axis=-3``."""
        b, dy, dx = self.shape["batch"], self.shape["dy"], self.shape["dx"]
        home = lambda t: t.to(self.home, non_blocking=True)  # noqa: E731
        rows = [
            torch.cat([torch.cat([home(blocks[(p, i, j)]) for j in range(dx)], dim=y_axis + 1)
                       for i in range(dy)], dim=y_axis)
            for p in range(b)
        ]
        return torch.cat(rows, dim=0)


def make_mesh(n_slots: int | None = None, *, device) -> SlotMesh:
    """A slot mesh of ``factor3(n_slots)`` on ``device``, which the caller
    names. ``"cuda"`` places the slots round-robin over the visible cards
    (one slot per card when ``n_slots`` is None, as JAX's ``make_mesh()``
    takes every device); ``"cuda:N"`` places every slot on card N;
    ``"cpu"`` every slot on the CPU (one slot when ``n_slots`` is None).
    Asking for a card where there is none raises: nothing moves to the CPU
    by itself."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: device {device!r} asked for, but no CUDA device is visible")
        cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                 if dev.index is None else [dev])
    elif dev.type == "cpu":
        cards = [dev]
    else:
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    if n_slots is None:
        n_slots = len(cards) if dev.type == "cuda" else 1
    shape = factor3(n_slots)
    slots = [tuple(int(v) for v in s) for s in np.ndindex(*shape)]
    return SlotMesh({s: cards[n % len(cards)] for n, s in enumerate(slots)}, shape)
