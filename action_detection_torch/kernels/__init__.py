"""The port's hand-written CUDA kernels: wrappers, plain versions and the
launch counters that show which kernels a run went through."""

from .int8 import (int8_avg_pool, int8_avg_pool_exclude_pad,
                   int8_avg_pool_plain, int8_conv, int8_conv_plain,
                   int8_max_pool, int8_max_pool_plain)
from .pool_bwd import max_pool_bwd, max_pool_bwd_plain

#: every kernel wrapper; each adds one to its ``launches`` per launch
KERNELS = (int8_conv, int8_max_pool, int8_avg_pool,
           int8_avg_pool_exclude_pad, max_pool_bwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
