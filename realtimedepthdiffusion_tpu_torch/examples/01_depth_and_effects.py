"""One-shot depth estimation + all three effects via the model facade
(twin of ``examples/01_depth_and_effects.py`` on the PyTorch port).

Loads an (image, annotation) pair in the reference's dataset format
(annotation PNG: gray value 32 = unannotated, anything else = a depth
scribble — SURVEY.md C4), diffuses the scribbles into a dense depth map
with the reference schedule on ``--device`` (the card by default), and
renders refocus / desaturation / haze.
"""

# Allow running from a source checkout without `pip install -e .`: the
# script's own dir is on sys.path, the repo root (two levels up) is not.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import os

from realtimedepthdiffusion_tpu_torch.io import depth_to_u8, imread_rgb, imwrite, load_annotation
from realtimedepthdiffusion_tpu_torch.models import ChebyshevCascade


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", required=True)
    p.add_argument("--annotation", required=True)
    p.add_argument("--out", default="rtdd_example")
    p.add_argument("--iterations", type=int, default=1000,
                   help="coarsest-level sweep budget (1000 = reference schedule)")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    rgb = imread_rgb(args.image)
    mask, value = load_annotation(args.annotation)

    model = ChebyshevCascade(max_iterations=args.iterations, device=args.device)
    depth = model.solve(rgb, mask, value)  # (H, W) float32 in [0, 255]

    os.makedirs(args.out, exist_ok=True)
    imwrite(os.path.join(args.out, "DepthMap.png"), depth_to_u8(depth))
    for key, name in (("b", "refocus"), ("g", "desaturation"), ("h", "haze")):
        art = model.render(rgb, depth, effect=key)
        imwrite(os.path.join(args.out, f"Effect_{name}.png"), art)
    print(f"wrote DepthMap.png + 3 effects to {args.out}")
    return depth


if __name__ == "__main__":
    main()
