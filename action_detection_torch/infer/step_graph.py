"""CUDA graphs of the scoring path's model step
(``infer/features.py:CropFeatureScorer._score_chunk``).

A scorer's :class:`StepGraphs` runs the step of a chunk key (shape, dtype,
stacks) eagerly on the key's first chunk, which warms cuDNN and cuBLAS up,
captures it before the second and replays it for every later chunk of that
key: one launch in place of the few hundred that the step's Python enqueues
one op at a time, with the GIL released while the card's work is enqueued.

:meth:`CudaStepGraph.capture` captures the step on its device's capture
stream in ``thread_local`` mode, so the decode pool and the scorers of
other threads go on meanwhile, one capture at a time in the process;
:meth:`CudaStepGraph.replay` launches it on the current stream.

Every graph of a device takes its intermediates from one memory pool, kept
for the life of the process: a graph dropped with its scorer leaves its
blocks to the graphs captured after it, so a process that builds a scorer a
call holds one pool a device, not one a scorer it built. The graphs share
the pool safely because every replay runs on the device's default stream,
which the scorers' threads all use: no two graphs of a device run at once.
The pool is held by a graph of one kernel, captured first and never
replayed: torch frees a graph pool, on the card and in pinned host memory,
once no graph holds it, and captures into it no more after that (a
``torch.cuda.MemPool`` holds only the card's side).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels import add_launch_counts, tally_launches

#: one capture at a time in the process
_LOCK = threading.Lock()
#: per CUDA device: the stream every capture runs on (a pool's free blocks
#: belong to the stream they were captured on, so captures that share a
#: pool share the stream) and the graph that holds the pool every graph
#: allocates from
_POOLS: Dict[torch.device, Tuple["torch.cuda.Stream",
                                 "torch.cuda.CUDAGraph"]] = {}


class CudaStepGraph:
    """One model step, captured on ``device`` into the device's pool."""

    def __init__(self, device):
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._graph = torch.cuda.CUDAGraph()

    def capture(self, step: Callable[[], torch.Tensor]) -> torch.Tensor:
        """``step()`` captured, not run; its output, which every
        :meth:`replay` rewrites."""
        with _LOCK:
            if self.device not in _POOLS:
                with torch.cuda.device(self.device):
                    stream = torch.cuda.Stream()
                    holder = torch.cuda.CUDAGraph()
                    _capture(holder, stream, None,
                             lambda: torch.zeros(1, device=self.device))
                _POOLS[self.device] = (stream, holder)
            stream, holder = _POOLS[self.device]
            return _capture(self._graph, stream, holder.pool(), step)

    def replay(self) -> None:
        self._graph.replay()


def _capture(graph, stream, pool, step):
    """``step()`` captured into ``graph`` on ``stream``, allocating from
    ``pool`` (a new pool where None)."""
    with torch.cuda.stream(stream):
        graph.capture_begin(pool, capture_error_mode="thread_local")
        try:
            return step()
        finally:
            graph.capture_end()


@dataclasses.dataclass
class CapturedStep:
    """A chunk key's model step as a graph: ``static_in``, which each chunk
    is copied into, ``static_out``, which each replay rewrites, and
    ``launches``, the counted kernel launches (by counter) of one replay."""
    graph: object
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: Dict[str, int]


class StepGraphs:
    """A scorer's model steps by chunk key: ``steps`` maps a key to None
    after its first chunk, then to its :class:`CapturedStep`. ``captures``
    counts the steps captured and ``replays`` the chunks replayed; both
    outlive clearing ``steps``, which drops the graphs (their memory goes
    to the device's later graphs)."""

    def __init__(self):
        self.steps: Dict[tuple, Optional[CapturedStep]] = {}
        self.captures = 0
        self.replays = 0

    def run(self, step: Callable[[torch.Tensor], torch.Tensor],
            frames: torch.Tensor, key: tuple,
            make_graph: Callable[[], object]) -> torch.Tensor:
        """``step(frames)``: eager on the first chunk of ``frames``' shape
        and dtype and ``key``, then captured into ``make_graph()`` (the
        launches it counts go to its tally, which each replay adds to the
        counters) and replayed."""
        key = (tuple(frames.shape), frames.dtype) + key
        if key not in self.steps:
            self.steps[key] = None
            return step(frames)
        captured = self.steps[key]
        if captured is None:
            graph = make_graph()
            static_in = torch.empty_like(frames)
            with tally_launches() as launches:
                static_out = graph.capture(lambda: step(static_in))
            captured = self.steps[key] = CapturedStep(graph, static_in,
                                                      static_out, launches)
            self.captures += 1
        captured.static_in.copy_(frames)
        captured.graph.replay()
        add_launch_counts(captured.launches)
        self.replays += 1
        # a later replay rewrites the static output
        return captured.static_out.clone()
