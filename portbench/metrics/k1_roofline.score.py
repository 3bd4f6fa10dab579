"""Kernels (``kernels/int8.py`` -> ``csrc/int8_conv.cu``, K1): the int8
convs' bound over their device time, in percent. The bound is the layer
table's int8 convs (each input byte read once and output byte written
once at 3.35 TB/s, or its operations at 1,979 TOP/s, the longer) for every
tick scored on the device, padding included, since the kernel computes
those rows too; the time is the device time of the kernels whose name
holds :data:`KERNEL`."""

from portbench.harness.layers import per_tick
from portbench.harness.peaks import row_bound_s

KERNEL = "int8_conv_kernel"


def read(run):
    if not run.intervals:
        return None
    lo, hi = run.window_ns
    ns = sum(b - a for a, b, name in run.intervals
             if KERNEL in name and a >= lo and b <= hi)
    if not ns:
        return None
    bound = per_tick(run.config, row_bound_s,
                     lambda r: r["op"] == "conv" and r["precision"] == "int8")
    return 100.0 * bound * run.device_ticks / (ns / 1e9)
