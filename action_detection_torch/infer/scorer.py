"""Proposal scorer: the dense-scoring inference path (torch port of
``action_detection_tpu/infer/scorer.py``).

* The CNN runs once per sampled frame; every proposal is scored by pooling
  the shared per-frame score matrix (linear-head commutation).
* With 10 device crops (the default) the host only decodes and rescales
  frames (in parallel); normalization, the oversample and the crop mean
  run on the device. With the shared stem (the int8-e2e default) the stem
  runs once per frame and its flip, and the 10 crop windows are cut from
  its output. ``test_crops=1`` (or ``device_crops=False``) cuts the crops
  on the host (``infer/features.py``).
* Frame chunks are padded to a fixed tick count, as in the JAX package.
* Proposal pooling is the cumsum-gather STPP on the device
  (``ops/stpp.py``), with part bounds from the host.
* ``score_video_pack`` (``--pack``) packs ticks of several videos into the
  same chunks: the padding is paid once per pack, not once per video, and
  the scores are equal to per-video scoring (every row of a chunk is
  scored on its own).
* ``score_videos`` fans videos out over devices: one thread and one scorer
  per device pulling from one queue, no collectives (the reference's
  process per GPU, without processes). The int8-e2e calibration of the
  first chunk is elected once and shared, so the scores do not depend on
  the device count. ``make_sharded_frame_scorer`` splits one video's frames
  over the devices instead.
* A chunk is built in a slot of the scorer's :class:`StagingRing`, reused
  host buffers (pinned on a CUDA device; a packed chunk's rows gathered
  in one native call, ``utils/native.py:gather_rows``), and copied from
  it on its device's copy stream, which the model step waits on.
* On a CUDA device with the calibrated int8-e2e backbone the model step
  of a chunk key (shape, dtype) runs eagerly on the key's first chunk,
  which warms cuDNN and cuBLAS up, is captured as one CUDA graph before
  the second, and is replayed from then on (``infer/step_graph.py``): each
  chunk is copied into the graph's static input, and its scores are a
  clone of the static output. Elsewhere (the CPU, ``perlayer``, the float
  backbones, a scorer still to calibrate) the step stays eager.
* Under a profiler the scoring thread's host work is recorded as spans
  (``utils/meters.py``): per chunk ``chunk.stack`` (building it in its
  slot), ``chunk.h2d`` (enqueueing its copy) and ``chunk.launch``
  (enqueueing the model step); per work item ``pack.finish`` (pooling and
  readback).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..data.pipeline import (iter_windowed_decode, load_scaled_stack,
                             pad_chunk_ticks)
from ..data.ssn_dataset import SSNDataset, TestSample
from ..data.transforms import preprocess_frames
from ..kernels import add_launch_counts, tally_launches
from ..models.backbones import InputSpec
from ..models.ssn import SSN, fuse_test_heads
from ..ops.stpp import (ReorganizedScoreLayout, StppConfig,
                        reorganized_stpp_pool)
from ..utils.meters import profiler, span_begin, span_end
from ..utils.native import gather_rows
from .features import CropFeatureScorer, fan_out, on_device
from .step_graph import CudaStepGraph

#: videos a ``--pack`` work item holds (bounds the host memory of a pack)
PACK_GROUP = 16
#: slots of a staging ring, per chunk shape: one is filled while the
#: other's copy is in flight, and that copy (0.34 ms for a 16.7 MB chunk
#: on an H100) ends long before its slot is written again, a chunk (15 ms
#: or more) later
STAGING_SLOTS = 2
#: per CUDA device: the stream its staging rings copy on, one a device: the
#: caching allocator hands a freed block out again only on the stream that
#: allocated it, so with a stream a ring no later scorer would reuse the
#: blocks of a scorer's chunks
_COPY_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_COPY_LOCK = threading.Lock()


@dataclasses.dataclass
class StagingSlot:
    """A reused host buffer of a :class:`StagingRing`: ``host`` (pinned
    for a CUDA device), ``array`` its numpy view, ``key`` its shape and
    dtype, and ``event`` the event of its last copy until the host has
    waited on it."""
    host: torch.Tensor
    array: np.ndarray
    key: tuple
    event: object = None


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _COPY_LOCK:
        if device not in _COPY_STREAMS:
            _COPY_STREAMS[device] = torch.cuda.Stream(device)
        return _COPY_STREAMS[device]


def _wait(slot: StagingSlot) -> None:
    if slot.event is not None:
        slot.event.synchronize()
        slot.event = None


class StagingRing:
    """The host buffers a scorer's chunks reach its device from.

    Each chunk shape and dtype gets :data:`STAGING_SLOTS` slots, made on
    its first chunk and used in turn. On a CUDA device the slots are
    pinned and copied with ``non_blocking`` on the device's copy stream:
    the compute stream waits on the copy's event, and the device tensor is
    recorded on the compute stream, so the caching allocator does not hand
    its memory out while the model step may still read it. On the CPU a
    slot is a plain tensor and its copy a clone.

    The host never writes a slot whose last copy may still be in flight:
    :meth:`take` waits on that copy's event, and :meth:`send` has already
    waited for the next slot of its key, so the wait falls in the copy's
    enqueue. ``staged`` counts the chunks sent, ``allocated`` the slots
    made; both outlive :meth:`release`.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = (_copy_stream(device) if device.type == "cuda"
                        else None)
        self._rings: Dict[tuple, collections.deque] = {}
        self.staged = 0
        self.allocated = 0

    def take(self, shape, dtype) -> StagingSlot:
        """The slot that the next chunk of ``shape`` and ``dtype`` is to be
        written into, its last copy done."""
        key = (tuple(shape), np.dtype(dtype))
        ring = self._rings.get(key)
        if ring is None:
            torch_dtype = torch.from_numpy(np.empty(0, key[1])).dtype
            ring = self._rings[key] = collections.deque()
            for _ in range(STAGING_SLOTS):
                host = torch.empty(key[0], dtype=torch_dtype,
                                   pin_memory=self._stream is not None)
                ring.append(StagingSlot(host, host.numpy(), key))
            self.allocated += STAGING_SLOTS
        slot = ring[0]
        _wait(slot)
        return slot

    def send(self, slot: StagingSlot) -> torch.Tensor:
        """``slot``, the one :meth:`take` gave last for its key, copied to
        the device (enqueued, on a CUDA device); the next slot of its key
        is free to write on return."""
        ring = self._rings[slot.key]
        if ring[0] is not slot:
            raise ValueError("a staging slot is sent in the order taken")
        frames, slot.event = self._copy(slot.host)
        self.staged += 1
        ring.rotate(-1)
        _wait(ring[0])
        return frames

    def _copy(self, host: torch.Tensor):
        """``host`` on the device, and the event that marks the copy's end
        (None where the copy has ended on return)."""
        if self._stream is None:
            return host.clone(), None
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            frames = host.to(self.device, non_blocking=True)
            event = self._stream.record_event()
        compute.wait_event(event)
        frames.record_stream(compute)
        return frames, event

    def release(self) -> None:
        """Give the slots back (after their copies), keeping the counts."""
        for ring in self._rings.values():
            for slot in ring:
                _wait(slot)
        self._rings.clear()


@dataclasses.dataclass
class ScoredVideo:
    """Per-video inference result (the reference's result-queue tuple)."""
    video_id: str
    rel_props: np.ndarray     # (P, 2)
    act_scores: np.ndarray    # (P, K+1)
    comp_scores: np.ndarray   # (P, K)
    reg_scores: Optional[np.ndarray]   # (P, K, 2) denormalized
    raw_scores: Optional[np.ndarray] = None   # (T, D_out) fused frame scores

    def as_tuple(self):
        return (self.rel_props, self.act_scores, self.comp_scores,
                self.reg_scores)


@dataclasses.dataclass
class CapturedStep:
    """A chunk key's model step as a CUDA graph: ``static_in``, which each
    chunk is copied into, ``static_out``, which each replay rewrites, and
    ``launches``, the counted kernel launches (by counter) of one replay."""
    graph: object
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: Dict[str, int]


class ProposalScorer(CropFeatureScorer):
    """Holds the fused test FC, the (quantized) backbone and the decode pool
    (the feature step is :class:`~.features.CropFeatureScorer`'s)."""

    #: ``device ->`` a graph to capture a model step into
    #: (``capture(step)``, which returns the step's output, and ``replay()``)
    graph_factory = CudaStepGraph
    #: the device types whose scorers replay their model steps as graphs
    graph_devices = ("cuda",)

    def __init__(self, model: SSN, input_spec: InputSpec,
                 reg_stats: Optional[np.ndarray] = None,
                 num_class: Optional[int] = None,
                 stpp_cfg=(1, 1, 1), test_crops: int = 10,
                 chunk_frames: int = 32,
                 modality: str = "RGB",
                 device="cuda",
                 with_regression: bool = True,
                 quantize=False,
                 calibration_frames: Optional[np.ndarray] = None,
                 device_crops: Optional[bool] = None,
                 decode_threads: Optional[int] = None,
                 shared_stem: Optional[bool] = None,
                 prequantized=None, decode_pool=None):
        self.reg_stats = (np.asarray(reg_stats) if reg_stats is not None
                          else None)
        if with_regression and self.reg_stats is None:
            # silently emitting NORMALIZED regression scores would shift
            # every detection boundary downstream
            raise ValueError(
                "with_regression=True requires reg_stats (the checkpoint's "
                "regression-target normalization); pass with_regression=False "
                "to score without boundary regression")
        super().__init__(model, input_spec, test_crops=test_crops,
                         chunk_frames=chunk_frames, modality=modality,
                         device=device, quantize=quantize,
                         calibration_frames=calibration_frames,
                         device_crops=device_crops,
                         decode_threads=decode_threads,
                         shared_stem=shared_stem, prequantized=prequantized,
                         decode_pool=decode_pool)
        self.num_class = num_class or model.num_class
        self.with_regression = with_regression

        kernel, bias = fuse_test_heads(model, self.num_class, stpp_cfg,
                                       with_regression=with_regression)
        self._kernel = kernel.to(self.device)
        self._bias = bias.to(self.device)
        self._reg_stats_dev = (torch.as_tensor(self.reg_stats,
                                               dtype=torch.float32,
                                               device=self.device)
                               if self.reg_stats is not None else None)
        self.stpp = StppConfig.from_raw(stpp_cfg)
        K = self.num_class
        self.layout = ReorganizedScoreLayout(
            act_len=K + 1, comp_len=K, reg_len=2 * K,
            feat_multiplier=self.stpp.feat_multiplier,
            with_regression=with_regression)
        #: the host buffers chunks are built in and copied from
        self.staging = StagingRing(self.device)
        #: model steps captured as CUDA graphs, and chunks scored by a
        #: replay; both outlive :meth:`close`
        self.graph_captures = 0
        self.graph_replays = 0
        # by chunk key: its captured step, or None after its first chunk
        self._steps: Dict[tuple, Optional[CapturedStep]] = {}

    def close(self) -> None:
        """Shut down the decode pool it owns, give back the staging slots
        and drop the captured steps, whose memory the device's later graphs
        reuse (idempotent)."""
        super().close()
        self.staging.release()
        self._steps.clear()

    def _score_chunk(self, frames_u8: torch.Tensor,
                     n_stacks: int) -> torch.Tensor:
        """uint8 frames on the device (``(n_stacks, H_scale, W_scale, C)``,
        or ``test_crops * n_stacks`` host crops) -> ``(n_stacks, D)``
        crop-mean fused scores: the model step, replayed as its chunk key's
        CUDA graph where it can be (the module's docstring)."""
        sp = profiler._is_profiler_enabled and span_begin("chunk.launch")
        if (self.device.type in self.graph_devices
                and self._quantize_mode == "e2e"
                and not self.needs_lazy_calibration):
            scores = self._graph_step(frames_u8, n_stacks)
        else:
            scores = self._model_step(frames_u8, n_stacks)
        if sp:
            span_end(sp)
        return scores

    def _model_step(self, frames_u8: torch.Tensor,
                    n_stacks: int) -> torch.Tensor:
        """The model step, eager. Crops are mean-reduced on *features*
        before the fused FC — identical by linearity."""
        feats = self._crop_features(frames_u8)
        with torch.no_grad():
            feats = feats.reshape(self.test_crops, n_stacks, -1).mean(dim=0)
            return torch.matmul(feats, self._kernel) + self._bias

    def _graph_step(self, frames_u8: torch.Tensor,
                    n_stacks: int) -> torch.Tensor:
        """The model step as its key's graph: eager on the key's first
        chunk, captured on its second, replayed from then on."""
        key = (tuple(frames_u8.shape), frames_u8.dtype, n_stacks)
        if key not in self._steps:
            self._steps[key] = None
            return self._model_step(frames_u8, n_stacks)
        step = self._steps[key] or self._capture(key, frames_u8, n_stacks)
        step.static_in.copy_(frames_u8)
        step.graph.replay()
        add_launch_counts(step.launches)
        self.graph_replays += 1
        # a later replay rewrites the static output
        return step.static_out.clone()

    def _capture(self, key: tuple, frames_u8: torch.Tensor,
                 n_stacks: int) -> CapturedStep:
        """Capture the model step of ``key``; the launches it counts go to
        its tally, which each replay adds to the counters."""
        graph = self.graph_factory(self.device)
        static_in = torch.empty_like(frames_u8)
        with tally_launches() as launches:
            static_out = graph.capture(
                lambda: self._model_step(static_in, n_stacks))
        step = CapturedStep(graph, static_in, static_out, launches)
        self._steps[key] = step
        self.graph_captures += 1
        return step

    def _to_device(self, slot: StagingSlot) -> torch.Tensor:
        """A chunk built in ``slot`` on the device: a copy enqueued on the
        staging ring's copy stream, which the compute stream waits for."""
        sp = profiler._is_profiler_enabled and span_begin("chunk.h2d")
        frames = self.staging.send(slot)
        if sp:
            span_end(sp)
        return frames

    # --- host orchestration ---

    def _empty_scored(self, sample: TestSample,
                      keep_raw: bool = False) -> ScoredVideo:
        """Zero-score result for a video with no frame ticks."""
        P = sample.prop_ticks.shape[0]
        K = self.num_class
        D = self.layout.total_cols
        return ScoredVideo(
            video_id=sample.video_id, rel_props=sample.rel_props,
            act_scores=np.zeros((P, K + 1), np.float32),
            comp_scores=np.zeros((P, K), np.float32),
            reg_scores=(np.zeros((P, K, 2), np.float32)
                        if self.with_regression else None),
            raw_scores=np.zeros((0, D), np.float32) if keep_raw else None)

    def score_video(self, sample: TestSample, provider,
                    keep_raw: bool = False) -> ScoredVideo:
        """Score every sampled frame, pool per proposal, denormalize
        regression."""
        if len(sample.frame_ticks) == 0:
            return self._empty_scored(sample, keep_raw=keep_raw)
        chunks, host_crops = self._frame_chunks(sample, provider)
        T = len(sample.frame_ticks)
        out_chunks = []
        filled = 0
        for chunk in chunks:
            n_real = chunk.shape[0] // host_crops
            sp = profiler._is_profiler_enabled and span_begin("chunk.stack")
            chunk = pad_chunk_ticks(chunk, host_crops, self.chunk_frames)
            slot = self.staging.take(chunk.shape, chunk.dtype)
            slot.array[...] = chunk
            if sp:
                span_end(sp)
            out_chunks.append(self._score_chunk(self._to_device(slot),
                                                self.chunk_frames))
            filled += n_real
            self.device_ticks += self.chunk_frames
            self.real_ticks += n_real
        if filled != T:
            raise RuntimeError(f"scored {filled} of {T} ticks of "
                               f"{sample.video_id}")
        sp = profiler._is_profiler_enabled and span_begin("pack.finish")
        out = self._pool_video(sample, torch.cat(out_chunks, dim=0), T,
                               keep_raw=keep_raw)
        if sp:
            span_end(sp)
        return out

    def _pool_video(self, sample: TestSample, frame_scores: torch.Tensor,
                    T: int, keep_raw: bool = False) -> ScoredVideo:
        """Pool one video's (T_padded, D) frame-score matrix into proposal
        scores."""
        with torch.no_grad():
            act, comp, reg = reorganized_stpp_pool(
                frame_scores, sample.prop_ticks, sample.prop_scaling,
                self.layout, self.stpp, num_frames=T)
            if reg is not None and self._reg_stats_dev is not None:
                stats = self._reg_stats_dev
                reg = reg.reshape(-1, self.num_class, 2) * stats[1] + stats[0]
        return ScoredVideo(
            video_id=sample.video_id, rel_props=sample.rel_props,
            act_scores=act.cpu().numpy(), comp_scores=comp.cpu().numpy(),
            reg_scores=reg.cpu().numpy() if reg is not None else None,
            raw_scores=(frame_scores[:T].cpu().numpy() if keep_raw
                        else None))

    def score_video_pack(self, samples, provider,
                         keep_raw: bool = False) -> List[ScoredVideo]:
        """Score several videos with their ticks packed across videos.

        ``score_video`` pads each video's ticks to a multiple of
        ``chunk_frames``; here ticks of consecutive videos share chunks, so
        a pack pays that padding once (per scale shape: videos whose
        scaled frames differ in shape pack in separate buffers, and each
        buffer's partial last chunk is padded). Every row of a chunk is
        scored on its own, so the scores equal per-video scoring. The rows
        come back to per-video matrices on the device: one
        ``index_select`` over the chunks' scores and an appended zero row,
        with indices computed on the host; each matrix has the row count
        ``score_video`` gives the pool. The host-crop path scores per
        video (its chunks are crop-major per video).
        """
        if not self.device_crops:
            return [self.score_video(s, provider, keep_raw=keep_raw)
                    for s in samples]
        scale = self.input_spec.scale_size

        def load_one(job) -> np.ndarray:
            s = samples[job[0]]
            return load_scaled_stack(provider, s.video_id, job[2],
                                     s.num_frames, scale, self.new_length)

        jobs = [(si, row, tick) for si, s in enumerate(samples)
                for row, tick in enumerate(s.frame_ticks)]
        decoded = iter_windowed_decode(jobs, load_one, self._decode_pool,
                                       window=4 * self.chunk_frames)
        pending = []        # (chunk scores on the device, [(video, row)])

        def flush(buf) -> None:
            sp = profiler._is_profiler_enabled and span_begin("chunk.stack")
            tick = buf[0][2]
            slot = self.staging.take((self.chunk_frames,) + tick.shape,
                                     tick.dtype)
            gather_rows(slot.array, [a for _, _, a in buf])
            slot.array[len(buf):] = 0       # a partial chunk's padding
            if sp:
                span_end(sp)
            scores = self._score_chunk(self._to_device(slot),
                                       self.chunk_frames)
            self.device_ticks += self.chunk_frames
            self.real_ticks += len(buf)
            pending.append((scores, [(si, row) for si, row, _ in buf]))

        buffers: Dict[tuple, list] = {}        # per scale shape
        for (si, row, _), arr in zip(jobs, decoded):
            buf = buffers.setdefault(arr.shape, [])
            buf.append((si, row, arr))
            if len(buf) == self.chunk_frames:
                flush(buf)
                buffers[arr.shape] = []
        for buf in buffers.values():            # partial chunks, padded
            if buf:
                flush(buf)
        if not pending:
            return [self._empty_scored(s, keep_raw=keep_raw)
                    for s in samples]

        sp = profiler._is_profiler_enabled and span_begin("pack.finish")
        row_of = {key: ci * self.chunk_frames + r
                  for ci, (_, keys) in enumerate(pending)
                  for r, key in enumerate(keys)}
        with torch.no_grad():
            first = pending[0][0]
            all_scores = torch.cat([sc for sc, _ in pending]
                                   + [first.new_zeros(1, first.shape[1])])
        zero_row = all_scores.shape[0] - 1
        outs = []
        for si, s in enumerate(samples):
            T = len(s.frame_ticks)
            if T == 0:
                outs.append(self._empty_scored(s, keep_raw=keep_raw))
                continue
            idx = np.full(-(-T // self.chunk_frames) * self.chunk_frames,
                          zero_row, np.int64)
            idx[:T] = [row_of[si, row] for row in range(T)]
            with torch.no_grad():
                mat = all_scores.index_select(
                    0, torch.from_numpy(idx).to(self.device))
            outs.append(self._pool_video(s, mat, T, keep_raw=keep_raw))
        if sp:
            span_end(sp)
        return outs


def make_sharded_frame_scorer(model: SSN, kernel: torch.Tensor,
                              bias: torch.Tensor, input_spec: InputSpec,
                              devices: Sequence, modality: str = "RGB"):
    """One long video's frames split over ``devices``: each device scores
    its contiguous slice of the frames (one thread each, a copy of the
    float model and the fused test FC on each), and the score matrix is
    gathered on the first device. Returns ``frames_u8 (N, H, W, C) ->
    scores (N, D)`` (crop-shaped uint8 frames, numpy or a tensor)."""
    devices = [torch.device(d) for d in devices]
    replicas = [(copy.deepcopy(model).eval().to(d), kernel.to(d),
                 bias.to(d)) for d in devices]
    new_length = model.resolved_new_length

    def part(i: int, frames: torch.Tensor) -> torch.Tensor:
        net, k, b = replicas[i]
        with on_device(devices[i]), torch.no_grad():
            x = preprocess_frames(frames.to(devices[i]), input_spec,
                                  modality, new_length)
            return torch.matmul(net.features(x), k) + b

    def score(frames_u8) -> torch.Tensor:
        parts = torch.tensor_split(torch.as_tensor(frames_u8), len(devices))
        outs = _run_threads([lambda i=i, f=f: part(i, f)
                             for i, f in enumerate(parts)])
        return torch.cat([o.to(devices[0]) for o in outs])

    return score


def _run_threads(fns: Sequence[Callable]) -> list:
    """``fn()`` of each on a thread of its own; the results in order, or
    the first error raised."""
    results: list = [None] * len(fns)
    errors: list = []

    def run(i: int) -> None:
        try:
            results[i] = fns[i]()
        except BaseException as e:      # re-raised on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def score_videos(scorer_factory, dataset: SSNDataset, provider,
                 indices: Optional[Iterable[int]] = None,
                 devices: Optional[Sequence] = None, keep_raw: bool = False,
                 progress: bool = False,
                 pack: bool = False) -> Dict[str, ScoredVideo]:
    """Fan videos out over ``devices`` (default: every local GPU,
    ``parallel/mesh.py:select_devices``): independent work, no collectives
    (``features.py:fan_out``: one scorer and one thread a device, the
    lazy-calibration election). The work items are videos, or groups of
    ``PACK_GROUP`` with ``pack`` (``score_video_pack``; the group bounds
    the host memory of a pack). A device may appear twice: two scorers
    share it."""
    from ..parallel.mesh import select_devices

    indices = list(indices if indices is not None
                   else range(len(dataset.video_list)))
    items = ([indices[lo:lo + PACK_GROUP]
              for lo in range(0, len(indices), PACK_GROUP)] if pack
             else indices)
    results: Dict[str, ScoredVideo] = {}
    lock = threading.Lock()

    def score_item(scorer, item) -> None:
        if pack:
            outs = scorer.score_video_pack(
                [dataset.get_test_sample(i) for i in item], provider,
                keep_raw=keep_raw)
        else:
            outs = [scorer.score_video(dataset.get_test_sample(item),
                                       provider, keep_raw=keep_raw)]
        with lock:
            for out in outs:
                results[out.video_id] = out
                if progress:
                    print(f"scored {out.video_id} "
                          f"({len(results)}/{len(indices)})", flush=True)

    fan_out(scorer_factory,
            list(devices) if devices is not None else select_devices(),
            items, score_item)
    return results


def dump_scores_pickle(results: Dict[str, ScoredVideo], path: str,
                       raw_path: Optional[str] = None) -> None:
    """Reference-compatible pickle: {vid: (rel_props, act, comp, reg)}."""
    import pickle

    out = {vid: r.as_tuple() for vid, r in results.items()}
    with open(path, "wb") as f:
        pickle.dump(out, f, pickle.HIGHEST_PROTOCOL)
    if raw_path:
        raw = {vid: r.raw_scores for vid, r in results.items()}
        with open(raw_path, "wb") as f:
            pickle.dump(raw, f, pickle.HIGHEST_PROTOCOL)
