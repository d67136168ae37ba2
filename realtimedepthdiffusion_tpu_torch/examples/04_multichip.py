"""The batched multi-device step on a slot mesh (twin of
``examples/04_multichip.py`` on the PyTorch port).

`parallel.sharded.batched_step` is the scale-out unit: data parallelism
over a batch of images ('batch' axis) x 2-D spatial sharding within each
image ('dy','dx'), with k-wide halo exchanges between the blocks of the
k-sweep solver. `rtdd-serve-torch --multichip` drives exactly this step over
directory pairs. The mesh is one of slots, each on a device: one slot per
card by default, or ``--slots N`` over the cards there are (on one card,
all of them on it; ``--device cpu`` puts every slot on the CPU).
"""

# Allow running from a source checkout without `pip install -e .`: the
# script's own dir is on sys.path, the repo root (two levels up) is not.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse

from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects
from realtimedepthdiffusion_tpu_torch.parallel.mesh import make_mesh
from realtimedepthdiffusion_tpu_torch.parallel.sharded import batched_step


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rows", type=int, default=128)
    p.add_argument("--cols", type=int, default=192)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--slots", type=int, default=None,
                   help="mesh slots (default: one per card, one on the CPU)")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    mesh = make_mesh(args.slots, device=args.device)
    print(f"mesh: {mesh}")

    cfg = DiffusionConfig(max_iterations=args.iterations)
    fn, make_example_args = batched_step(
        mesh, rows=args.rows, cols=args.cols, cfg=cfg, effect=effects.EFFECT_HAZE
    )
    batch_args = make_example_args(mesh.shape["batch"])
    depth, state, art = fn(*batch_args)
    depth = depth.cpu().numpy()  # waits for the device
    print(f"depth batch {depth.shape} {depth.dtype}; effect batch {tuple(art.shape)} {art.dtype}")
    return depth


if __name__ == "__main__":
    main()
