"""An editing session: warm re-solves and the localized incremental path
(twin of ``examples/02_warm_edits.py`` on the PyTorch port).

`DepthSession` is the programmatic twin of the GUI (live/cli.py): it owns
the annotation planes, the brush, and the warm multigrid state. After the
first full solve, each additional scribble re-solves WARM — and with
`incremental_iterations > 0` a small stroke takes the localized windowed
path (a deep solve in a window around the stroke plus a coarse far-field
correction).
"""

# Allow running from a source checkout without `pip install -e .`: the
# script's own dir is on sys.path, the repo root (two levels up) is not.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import argparse
import time

from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.io import imread_rgb
from realtimedepthdiffusion_tpu_torch.live.session import DepthSession


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", required=True)
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--incremental", type=int, default=62,
                   help="windowed re-solve budget for small strokes (0 = always full)")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    rgb = imread_rgb(args.image)
    h, w = rgb.shape[:2]
    cfg = DiffusionConfig(
        max_iterations=args.iterations,
        incremental_iterations=args.incremental,
    )
    sess = DepthSession(rgb, cfg, device=args.device)

    # Scribble "near" (depth 0) across the center, "far" (254) at the top.
    sess.set_color_key(0)
    for x in range(w // 4, 3 * w // 4, 8):
        sess.paint(x, h // 2)
    sess.set_color_key(4)
    for x in range(w // 4, 3 * w // 4, 8):
        sess.paint(x, h // 8)

    t0 = time.perf_counter()
    depth = sess.solve()  # cold: the first launches + a full solve
    t1 = time.perf_counter()
    print(f"full solve (first in the process): {t1 - t0:.2f}s; "
          f"depth range [{depth.min():.0f}, {depth.max():.0f}]")

    # Small strokes -> warm re-solves (incremental path when enabled).
    kind = "incremental" if args.incremental else "full warm"
    sess.set_color_key(2)
    sess.paint(w // 2, 3 * h // 4)
    t0 = time.perf_counter()
    depth = sess.solve()
    t1 = time.perf_counter()
    print(f"{kind} re-solve #1: {(t1 - t0) * 1e3:.1f} ms")
    sess.paint(w // 2 + 12, 3 * h // 4)
    t0 = time.perf_counter()
    depth = sess.solve()
    t1 = time.perf_counter()
    print(f"{kind} re-solve #2 (steady state): {(t1 - t0) * 1e3:.1f} ms "
          "(host wall, incl. transfers)")

    # Two SIMULTANEOUS distant strokes in one frame (two-handed editing):
    # the session keeps them as separate dirty rects and window-solves each.
    sess.set_color_key(1)
    sess.paint(w // 8, 7 * h // 8)
    sess.set_color_key(3)
    sess.paint(7 * w // 8, 7 * h // 8)
    n_rects = len(sess.dirty_rects)
    t0 = time.perf_counter()
    depth = sess.solve()
    t1 = time.perf_counter()
    print(f"two-handed frame ({n_rects} dirty rects, {kind}): "
          f"{(t1 - t0) * 1e3:.1f} ms")
    print(sess.timing_report())
    return depth


if __name__ == "__main__":
    main()
