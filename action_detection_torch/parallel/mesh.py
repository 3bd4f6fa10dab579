"""Data parallelism on torch: device selection, the process group, batch
slices and metric means (port of ``action_detection_tpu/parallel/mesh.py``).

The JAX package runs one jitted program over a ``Mesh``; XLA inserts the
gradient all-reduce. The port uses torch's own idiom for training: one
process per GPU under ``torch.distributed`` (one *rank*), the model wrapped
in ``DistributedDataParallel``. A port rank stands for one JAX *process*
with one device: on one host ``--gpus 0 1 2 3`` spawns four ranks; with the
multi-host flags, global rank = ``process_id * local_gpus + local_index``
(:func:`global_rank`). Scoring needs no collectives: it runs one thread per
device in one process (``infer/scorer.py:score_videos``).

The backend is explicit: ``nccl`` for CUDA, ``gloo`` for the CPU. Several
ranks on one card must take ``gloo`` (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import inspect
import socket
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def local_devices(kind: str = "cuda") -> List[torch.device]:
    """This process's devices of ``kind``: every visible CUDA device, or
    the one CPU."""
    if kind == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def select_devices(indices: Optional[Sequence[int]] = None,
                   kind: str = "cuda") -> List[torch.device]:
    """Devices by LOCAL index (``--gpus``). None selects every local device
    of ``kind``, as ``jax.devices()`` does; duplicate or out-of-range
    indices raise ``ValueError`` with the JAX package's messages."""
    devs = local_devices(kind)
    if indices is None:
        return devs
    if len(set(indices)) != len(indices):
        raise ValueError(f"duplicate device indices in --gpus: {list(indices)}")
    bad = [i for i in indices if not 0 <= i < len(devs)]
    if bad:
        raise ValueError(f"device indices {bad} out of range: "
                         f"{len(devs)} local devices available")
    return [devs[i] for i in indices]


def cli_devices(device: str, indices: Optional[Sequence[int]] = None
                ) -> List[torch.device]:
    """The devices a CLI runs on, from ``--device`` and ``--gpus``: a CUDA
    ``--device`` with no card raises; ``cuda`` with no index takes
    ``--gpus`` (every local GPU when it is not given), ``cuda:N`` alone is
    that GPU; the CPU is one device (``--gpus 0`` at most)."""
    from ..infer.features import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None and indices is None:
        return [dev]
    devs = select_devices(indices, dev.type)
    if not devs:
        raise RuntimeError(f"no {dev.type} device to run on")
    return devs


def global_rank(process_id: int, local_count: int, local_index: int) -> int:
    """The rank of a process's ``local_index``-th device when each of the
    job's processes drives ``local_count`` of them."""
    return process_id * local_count + local_index


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: Optional[str],
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` through ``tcp://<coordinator_address>`` (``host:port``;
    rank 0 listens there) on ``backend`` (default: ``nccl`` where torch
    sees a GPU, else ``gloo``). No coordinator: a no-op, as in the JAX
    package. Returns whether a group was joined."""
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator_address needs --num_processes and "
                         "--process_id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if backend is None:
        backend = default_backend("cuda" if torch.cuda.is_available()
                                  else "cpu")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return True


def distributed() -> bool:
    """Whether this process is one of several ranks of a process group."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def process_count() -> int:
    """The world size (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def shard_batch(batch: Mapping[str, np.ndarray], rank: int,
                world: int) -> Dict[str, np.ndarray]:
    """This rank's rows of every array of a global batch (contiguous
    slices; the batch must divide by ``world``)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // world
        if n * world != v.shape[0]:
            raise ValueError(f"batch '{k}' of {v.shape[0]} rows does not "
                             f"divide over {world} ranks")
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def all_reduce_mean(metrics: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Each scalar metric averaged over the ranks (one all-reduce for all
    of them); unchanged outside a process group."""
    if not distributed() or not metrics:
        return dict(metrics)
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().to(torch.float64)
                           for k in keys])
    dist.all_reduce(stacked)
    stacked /= dist.get_world_size()
    return {k: stacked[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def wrap_ddp(model: nn.Module, device: torch.device) -> nn.Module:
    """``model`` (already on ``device``) under ``DistributedDataParallel``
    inside a process group (of one rank too), else ``model`` itself.

    Every trainable parameter takes part in every step, so no unused
    parameters are searched for. Buffers are not broadcast: the BatchNorm
    running statistics are updated from global batch statistics in every
    rank alike (``models/backbones/common.py``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return model
    from torch.nn.parallel import DistributedDataParallel

    device = torch.device(device)
    # newer torch names the switch forward_sync_buffers
    sync = ("forward_sync_buffers" if "forward_sync_buffers" in
            inspect.signature(DistributedDataParallel).parameters
            else "broadcast_buffers")
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        **{sync: False})


def unwrap(model: nn.Module) -> nn.Module:
    """The module under a ``DistributedDataParallel`` wrapper."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def free_port() -> int:
    """A TCP port free on this host now (for a single-host process group)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
