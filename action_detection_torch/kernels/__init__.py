"""The port's hand-written CUDA kernels: wrappers, plain versions and the
launch counters that show which kernels a run went through. The counters
also cover the C++ host kernels of ``utils/native.py`` (``host_nms``,
``host_tag_search``, which the evaluation and TAG paths call, and
``host_gather_rows``, one a packed scoring chunk), and the
frame decoder of ``data/image.py``, one counter a format
(``host_jpeg_decode``, ``host_png_decode``, ``host_bmp_decode``,
``host_pnm_decode``: one a decoded file), which every run on frame
directories calls. The int8 walks' concats are counted apart
(:func:`concat_counts`: ``concat_in_place``, ``concat_copied``, one an
Inception module's output, assembled in its branches' buffer or copied by
``torch.cat``), on either device, since no kernel runs for them."""

from ..data.image import DECODES
from ..utils.native import gather_rows, nms_indices, tag_box_search
from .int8 import (CONCAT_COPIED, CONCAT_IN_PLACE, COUNT_LOCK, count_launch,
                   int8_avg_pool, int8_avg_pool_exclude_pad,
                   int8_avg_pool_plain, int8_conv, int8_conv_plain,
                   int8_max_pool, int8_max_pool_plain, tally_launches)
from .pool_bwd import max_pool_bwd, max_pool_bwd_plain

#: every counted wrapper by its counter's name; each adds one to its
#: ``launches`` per launch
KERNELS = {k.__name__: k for k in (int8_conv, int8_max_pool, int8_avg_pool,
                                   int8_avg_pool_exclude_pad, max_pool_bwd)}
KERNELS.update(host_nms=nms_indices, host_tag_search=tag_box_search,
               host_gather_rows=gather_rows)
KERNELS.update({f"host_{f}_decode": c for f, c in DECODES.items()})
#: the walks' concat counters by name (:func:`concat_counts`)
CONCATS = {c.__name__: c for c in (CONCAT_IN_PLACE, CONCAT_COPIED)}


def reset_launch_counts() -> None:
    """Zero every counter, the concats' too."""
    for k in (*KERNELS.values(), *CONCATS.values()):
        k.launches = 0
    max_pool_bwd.bf16_launches = 0


def launch_counts() -> dict:
    """Every launch counter by name; ``max_pool_bwd/bf16`` counts the
    launches of ``max_pool_bwd`` in bfloat16 (``--bf16`` training)."""
    counts = {name: k.launches for name, k in KERNELS.items()}
    counts["max_pool_bwd/bf16"] = max_pool_bwd.bf16_launches
    return counts


def concat_counts() -> dict:
    """The int8 walks' module concats by counter name: ``concat_in_place``
    (a view of the module's buffer) and ``concat_copied`` (``torch.cat``)."""
    return {name: c.launches for name, c in CONCATS.items()}


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (by counter name; negative to take launches back) to
    the counters: the launches (and concats) a replayed CUDA graph made
    once more."""
    with COUNT_LOCK:
        for name, n in counts.items():
            (KERNELS.get(name) or CONCATS[name]).launches += n
