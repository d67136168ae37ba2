"""The port's CUDA kernels, their plain versions, their build and routing."""

from .defocus import defocus_block, defocus_box
from .fused_sweep import jc_sweep_fused
from .probe import residual_probe
from .rb_sweep import rb_sweep_resident, rb_sweep_tiles
from .sweep import jc_sweep_resident, jc_sweep_tiles
from .vc_smooth import vc_smooth_resident, vc_smooth_tiles

_KERNELS = (jc_sweep_tiles, jc_sweep_resident, defocus_box, rb_sweep_tiles,
            rb_sweep_resident, jc_sweep_fused, defocus_block, residual_probe, vc_smooth_tiles,
            vc_smooth_resident)


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset."""
    return {k.__name__: k.launches for k in _KERNELS}


def reset_launch_counts() -> None:
    for k in _KERNELS:
        k.launches = 0


def add_launches(tally: dict) -> None:
    """Add ``tally`` (wrapper name -> launches) to the counts. A CUDA graph
    launches its kernels without their wrappers: the pipeline takes the
    tally of a graph's capture back out (the capture launched nothing) and
    adds it again at each replay (``utils/program.py:Program``)."""
    for k in _KERNELS:
        k.launches += tally.get(k.__name__, 0)
