"""Directory batch serving with the async host-IO pipeline (twin of
``examples/03_batch_serving.py`` on the PyTorch port).

`serve.solve_pairs` is the programmatic core of `rtdd-serve-torch`: pairs
are matched by filename stem, one pipeline is built per distinct image
shape (shape bucketing), host PNG decode/encode runs on a thread pool that
overlaps the device solves, and each pair's readback waits until the next
solve is dispatched. Outputs are bit-identical to a sequential loop.
"""

# Allow running from a source checkout without `pip install -e .`: the
# script's own dir is on sys.path, the repo root (two levels up) is not.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse

from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects
from realtimedepthdiffusion_tpu_torch.serve import discover_pairs, solve_pairs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", required=True)
    p.add_argument("--annotations", required=True)
    p.add_argument("--out", default="rtdd_batch")
    p.add_argument("--limit", type=int, default=4, help="serve only the first N pairs")
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--io-workers", type=int, default=4)
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    pairs = discover_pairs(args.images, args.annotations)[: args.limit]
    cfg = DiffusionConfig(max_iterations=args.iterations)
    written = solve_pairs(
        pairs,
        args.out,
        cfg,
        effect=effects.EFFECT_HAZE,
        progress=lambda img_path, out_path: print(f"{img_path} -> {out_path}"),
        io_workers=args.io_workers,
        prefetch=args.prefetch,
        device=args.device,
    )
    print(f"wrote {len(written)} depth maps to {args.out}")
    return written


if __name__ == "__main__":
    main()
