"""The port's hand-written CUDA kernels: wrappers, plain versions and the
launch counters that show which kernels a run went through. The counters
also cover the C++ host kernels of ``utils/native.py`` (``host_nms``,
``host_tag_search``), which the evaluation and TAG paths call, and the
frame decoder of ``data/image.py``, one counter a format
(``host_jpeg_decode``, ``host_png_decode``, ``host_bmp_decode``,
``host_pnm_decode``: one a decoded file), which every run on frame
directories calls."""

from ..data.image import DECODES
from ..utils.native import nms_indices, tag_box_search
from .int8 import (int8_avg_pool, int8_avg_pool_exclude_pad,
                   int8_avg_pool_plain, int8_conv, int8_conv_plain,
                   int8_max_pool, int8_max_pool_plain)
from .pool_bwd import max_pool_bwd, max_pool_bwd_plain

#: every counted wrapper by its counter's name; each adds one to its
#: ``launches`` per launch
KERNELS = {k.__name__: k for k in (int8_conv, int8_max_pool, int8_avg_pool,
                                   int8_avg_pool_exclude_pad, max_pool_bwd)}
KERNELS.update(host_nms=nms_indices, host_tag_search=tag_box_search)
KERNELS.update({f"host_{f}_decode": c for f, c in DECODES.items()})


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    max_pool_bwd.bf16_launches = 0


def launch_counts() -> dict:
    """Every counter by name; ``max_pool_bwd/bf16`` counts the launches of
    ``max_pool_bwd`` in bfloat16 (``--bf16`` training)."""
    counts = {name: k.launches for name, k in KERNELS.items()}
    counts["max_pool_bwd/bf16"] = max_pool_bwd.bf16_launches
    return counts
