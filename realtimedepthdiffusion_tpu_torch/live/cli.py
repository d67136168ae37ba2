"""CLI (port of ``realtimedepthdiffusion_tpu/live/cli.py``), the reference's
argument contract (src/main.cpp:64-90):

    depth-diffusion-torch -i <image> [-a <annotation>] [--live] [-h]

plus the headless extensions of the JAX package's CLI, with the same
flags, defaults and errors, and one more:

    --device DEV       cuda (default), cuda:N or cpu: where the session
                       runs. Asking for a card where there is none raises;
                       nothing moves to the CPU by itself.

``--backend`` is parsed and validated, and routes nothing: the device of
the tensors picks the kernels or their plain versions. ``--trace DIR``
writes a ``torch.profiler`` trace of the solve. Where the JAX CLI enables
XLA's persistent cache, this one points the kernels' build at
``utils/cache.py``'s directory (``RTDD_CACHE_DIR``); there are no
background compiles.

Run as ``python -m realtimedepthdiffusion_tpu_torch.live.cli``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

from ..config import VALID_RESIDUAL_METRICS, DiffusionConfig
from ..io import imread_rgb

USAGE_SHORT = "Usage: depth-diffusion-torch -i ImageFile.Extension"

# --effect accepts the GUI key letters plus their long names.
_EFFECT_NAMES = {
    "b": "b", "refocus": "b", "defocus": "b",
    "g": "g", "grayscale": "g", "desaturation": "g", "desaturate": "g",
    "h": "h", "haze": "h",
}
USAGE = (
    "Usage:\n -i input image\n -a annotated image\n --live solve every frame\n"
    " --headless run without GUI\n --solve run one solve (headless)\n"
    " --effect b|g|h (refocus|desaturation|haze) artistic effect\n --save-dir DIR output directory\n"
    " --checkpoint F save full session state\n --resume F restore session state\n --backend xla|pallas|auto\n --profile faithful|fast named solver profile\n --solver jacobi_chebyshev|jacobi|red_black\n"
    " --multigrid cascadic|vcycle\n --incremental N windowed live re-solve budget\n"
    " --early-exit residual-tolerance early exit (any solver)\n --tolerance X residual tolerance (default 1e-5)\n"
    " --residual-metric rms|max early-exit residual functional (default rms)\n"
    " --rb-rho X red-black Chebyshev rho (default 0.9999)\n --rb-plain disable red-black SOR omegas\n"
    " --gray-pyramid opencv|floor gray-chain convention\n"
    " --defocus-quality auto|exact|approx refocus window-half set (auto =\n"
    "   exact through ~1440p, bounded-error approx at 4K+, loudly reported)\n"
    " --defocus-stride N approx candidate stride (default 4)\n"
    " --depth16 also save a 16-bit DepthMap16.png\n --time print timing report\n"
    " --trace DIR dump a torch.profiler trace of the solve\n --verbose debug logging\n"
    " --device cuda|cuda:N|cpu where the session runs (default cuda)\n"
)


@dataclasses.dataclass
class CliArgs:
    image: Optional[str] = None
    annotation: Optional[str] = None
    live: bool = False
    headless: bool = False
    solve: bool = False
    effect: Optional[str] = None
    save_dir: Optional[str] = None
    checkpoint: Optional[str] = None
    resume: Optional[str] = None
    show_time: bool = False
    trace_dir: Optional[str] = None
    verbose: bool = False
    backend: str = "auto"
    profile: Optional[str] = None
    solver: Optional[str] = None  # None -> profile choice or jacobi_chebyshev
    multigrid: str = "cascadic"
    incremental: Optional[int] = None  # None -> profile choice or 0
    early_exit: bool = False
    tolerance: Optional[float] = None
    residual_metric: Optional[str] = None
    rb_rho: Optional[float] = None
    rb_plain: bool = False
    gray_pyramid: str = "opencv"
    depth16: bool = False
    defocus_quality: Optional[str] = None  # None -> 'auto' (the default)
    defocus_stride: Optional[int] = None
    help: bool = False
    device: str = "cuda"


def _is_device(v: str) -> bool:
    """Whether ``v`` names the CPU or a CUDA device."""
    import torch

    try:
        return torch.device(v).type in ("cpu", "cuda")
    except RuntimeError:
        return False


def parse_args(argv: List[str]) -> CliArgs:
    """Hand-rolled to preserve the reference's loose parsing (flags may
    appear in any order; unknown flags are ignored, src/main.cpp:81-90)."""
    a = CliArgs()
    i = 0
    while i < len(argv):
        arg = argv[i]

        def val() -> str:
            nonlocal i
            i += 1
            if i >= len(argv):
                raise SystemExit(f"error: {arg} requires a value\n{USAGE}")
            return argv[i]

        if arg == "-i":
            a.image = val()
        elif arg == "-a":
            a.annotation = val()
        elif arg == "--live":
            a.live = True
        elif arg == "--headless":
            a.headless = True
        elif arg == "--solve":
            a.solve = True
        elif arg == "--effect":
            # The reference's key letters (src/main.cpp:190-230) and their
            # long names; anything else fails loudly: a silently ignored
            # effect saves an all-zeros ArtisticEffect.png.
            v = val().lower()
            a.effect = _EFFECT_NAMES.get(v)
            if a.effect is None:
                raise SystemExit(
                    f"error: unknown --effect {v!r} "
                    f"(choose from {sorted(_EFFECT_NAMES)})\n{USAGE}"
                )
        elif arg == "--save-dir":
            a.save_dir = val()
        elif arg == "--checkpoint":
            a.checkpoint = val()
        elif arg == "--resume":
            a.resume = val()
        elif arg == "--time":
            a.show_time = True
        elif arg == "--trace":
            a.trace_dir = val()
        elif arg == "--verbose":
            a.verbose = True
        elif arg == "--backend":
            a.backend = val()
        elif arg == "--profile":
            v = val().lower()
            if v not in ("faithful", "fast"):
                raise SystemExit(
                    f"error: unknown --profile {v!r} "
                    f"(choose from ['faithful', 'fast'])\n{USAGE}"
                )
            a.profile = v
        elif arg == "--solver":
            a.solver = val()
        elif arg == "--multigrid":
            a.multigrid = val()
        elif arg == "--incremental":
            try:
                a.incremental = int(val())
            except ValueError:
                raise SystemExit(f"error: --incremental expects an integer\n{USAGE}")
        elif arg == "--early-exit":
            a.early_exit = True
        elif arg == "--tolerance":
            try:
                a.tolerance = float(val())
            except ValueError:
                raise SystemExit(f"error: --tolerance expects a number\n{USAGE}")
        elif arg == "--residual-metric":
            v = val().lower()
            if v not in VALID_RESIDUAL_METRICS:
                raise SystemExit(
                    f"error: unknown --residual-metric {v!r} "
                    f"(choose from {sorted(VALID_RESIDUAL_METRICS)})\n{USAGE}"
                )
            a.residual_metric = v
        elif arg == "--rb-rho":
            try:
                a.rb_rho = float(val())
            except ValueError:
                raise SystemExit(f"error: --rb-rho expects a number\n{USAGE}")
        elif arg == "--rb-plain":
            a.rb_plain = True
        elif arg == "--gray-pyramid":
            v = val().lower()
            if v not in ("opencv", "floor"):
                raise SystemExit(
                    f"error: unknown --gray-pyramid {v!r} "
                    f"(choose from ['floor', 'opencv'])\n{USAGE}"
                )
            a.gray_pyramid = v
        elif arg == "--depth16":
            a.depth16 = True
        elif arg == "--defocus-quality":
            v = val().lower()
            if v not in ("auto", "exact", "approx"):
                raise SystemExit(
                    f"error: unknown --defocus-quality {v!r} "
                    f"(choose from ['auto', 'exact', 'approx'])\n{USAGE}"
                )
            a.defocus_quality = v
        elif arg == "--defocus-stride":
            try:
                a.defocus_stride = int(val())
            except ValueError:
                raise SystemExit(
                    f"error: --defocus-stride expects an integer\n{USAGE}"
                )
            if a.defocus_stride < 2:
                raise SystemExit(
                    "error: --defocus-stride must be >= 2 (1 is the exact "
                    f"kernel; use --defocus-quality exact)\n{USAGE}"
                )
        elif arg == "--device":
            v = val().lower()
            if not _is_device(v):
                raise SystemExit(
                    f"error: unknown --device {v!r} (choose from cuda, cuda:N, cpu)\n{USAGE}"
                )
            a.device = v
        elif arg == "-h" or arg == "--help":
            a.help = True
        i += 1
    return a


def make_config(a: CliArgs) -> DiffusionConfig:
    """Every solver-facing flag lands in the config. ``--profile fast`` sets
    a base (red_black + RMS early exit at 1e-3 + the 120-iteration
    incremental live path); explicit flags override the profile's choices.
    ``--profile faithful`` (and no profile) keeps the reference-faithful
    defaults."""
    from ..flags import resolve_solver_flags

    def fail(msg: str):
        raise SystemExit(f"error: {msg}\n{USAGE}")

    kw = resolve_solver_flags(a, fail)
    # Live-CLI-only extras on top of the shared surface:
    incremental = a.incremental if a.incremental is not None else (
        120 if a.profile == "fast" else 0
    )
    kw["incremental_iterations"] = max(int(incremental), 0)
    kw["gray_pyramid"] = a.gray_pyramid
    return DiffusionConfig(**kw)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(USAGE_SHORT)
        return 0
    a = parse_args(argv)
    if a.help:
        print(USAGE)
        if a.image is None:
            return 0
    if a.image is None:
        print(USAGE_SHORT)
        return 0

    if a.verbose:
        import logging

        logging.basicConfig(level=logging.DEBUG, format="%(name)s %(message)s")

    from ..utils.cache import enable_compilation_cache
    from .session import DepthSession

    enable_compilation_cache()
    rgb = imread_rgb(a.image)
    session = DepthSession(rgb, make_config(a), device=a.device)
    session.save_depth16 = a.depth16
    if a.annotation:
        session.load_annotation_file(a.annotation)
    if a.resume:
        session.load_checkpoint(a.resume)
    if a.effect:
        session.set_effect_key(a.effect)

    if a.headless:
        if a.solve or a.live or a.effect:
            if a.trace_dir:
                from ..utils.timing import device_trace

                with device_trace(a.trace_dir, device=session.device):
                    session.solve()
                print(f"Profiler trace written to {a.trace_dir}")
            else:
                session.solve()
            if a.show_time:
                print(session.timing_report())
                print(session.residual_report())
        if a.save_dir:
            paths = session.save(a.save_dir, depth16=a.depth16)
            print("Saving images...")
            for p in paths:
                print(f"  {p}")
        if a.checkpoint:
            session.save_checkpoint(a.checkpoint)
            print(f"Checkpoint saved: {a.checkpoint}")
        return 0

    from .gui import run_gui  # imports cv2 (I/O boundary)

    return run_gui(session, live=a.live)


if __name__ == "__main__":
    raise SystemExit(main())
