"""What the two scorers share: the path from a list of samples to each
chunk's scores on the device, and the feature step on it.

:class:`CropFeatureScorer` holds the backbone (float, int8-e2e after
calibration, or per-layer int8), the crop path, the shared-stem choice and
the host decode pool. Two crop paths, as in the JAX package: 10 device
crops (the default: the host ships one scale-size frame a tick and the
oversample is cut on the device), or host crops (``test_crops`` 1, or 10
with ``device_crops=False``: the host cuts them through
``make_test_transform``). :class:`~.scorer.ProposalScorer` (SSN proposal
scoring) means the features over the crops before its fused FC;
:class:`~.actionness.ActionnessScorer` (dense actionness for TAG) keeps
every crop's score; each adds only its head (``_model_step``) and its
readout. Constructing either turns TF32 off for cuDNN and matmuls, for
parity with the JAX package's float32 convs and ``Precision.HIGHEST``
heads.

* :meth:`CropFeatureScorer._chunks` builds each chunk in a slot of a
  :class:`StagingRing` (reused host buffers, pinned on a CUDA device) and
  copies it on the device's copy stream. With device crops the ticks of
  several samples share chunks: decoded on the decode pool, one buffer a
  scale shape, gathered in one native call
  (``utils/native.py:gather_rows``), a partial chunk padded with zero
  ticks. With host crops a chunk holds one sample's crop-major crops.
* :meth:`CropFeatureScorer._score_chunk` replays the model step as its
  chunk key's CUDA graph (``infer/step_graph.py``) on a CUDA device with
  the calibrated int8-e2e backbone, and runs it eagerly elsewhere (the
  CPU, ``perlayer``, the float backbones, a scorer still to calibrate).
* Under a profiler each chunk's host work is a span (``utils/meters.py``):
  ``chunk.stack`` (building it in its slot), ``chunk.h2d`` (enqueueing its
  copy) and ``chunk.launch`` (enqueueing the model step).

Several scorers may score at once, one per device and thread (the
fan-out of ``infer/scorer.py:score_videos`` and ``binary_test``): each
holds its own copy of the weights on its device, the int8 tree comes from
one calibration (``prequantized=``, :meth:`install_prequantized`), and a
decode pool may be shared (``decode_pool=``) so the decode threads stay
``-j`` in all.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..data.pipeline import (iter_test_frame_batches, iter_windowed_decode,
                             load_scaled_stack, make_decode_pool,
                             make_test_transform, pad_chunk_ticks)
from ..data.transforms import (device_normed_pair, device_oversample_normed,
                               preprocess_frames)
from ..models.backbones import InputSpec
from ..models.backbones.bn_inception_int8 import (bninception_int8_features,
                                                  calibrate_activation_scales,
                                                  quantize_backbone, tree_to)
from ..models.backbones.quantize import (calibrate_e2e_backbone,
                                         int8_e2e_features,
                                         int8_e2e_features_sharedstem,
                                         int8_support_error, supports_int8,
                                         supports_shared_stem)
from ..train.trainer import float32_convs_and_matmuls
from ..utils.meters import profiler, span_begin, span_end
from ..utils.native import gather_rows
from .step_graph import CudaStepGraph, StepGraphs

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


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises (the
    port never continues on the CPU in place of a requested GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch sees no CUDA "
                           "device")
    return dev


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


class CropFeatureScorer:
    """Backbone features of each crop of each frame, float or int8.

    ``model`` is an ``SSN`` or a ``BinaryClassifier`` (``arch``,
    ``base_model``, ``features``, ``resolved_new_length``). ``quantize``:
    False (float), ``"e2e"`` (or True) or ``"perlayer"``. The e2e backbone
    calibrates on ``calibration_frames`` (crop-shaped or scale-size uint8
    frames), on a sibling scorer's ``export_quantized()``
    (``prequantized``), or else on the first scored chunk; the per-layer
    one takes static scales from ``calibration_frames``, or dynamic scales
    without them. A float model is copied to the device (the caller's
    stays where it is, so scorers on several devices can share it).
    ``decode_pool``: a decode executor shared with other scorers, which
    :meth:`close` leaves running (default: a pool of its own of
    ``decode_threads``). A subclass defines ``_model_step(frames_u8,
    n_stacks)``, a chunk's scores from its uint8 frames on the device.
    """

    #: ``device ->`` a graph to capture a model step into
    #: (``capture(step)``, which returns the step's output, and ``replay()``)
    graph_factory = CudaStepGraph
    #: the device types whose scorers replay their model steps as graphs
    graph_devices = ("cuda",)

    def __init__(self, model, input_spec: InputSpec, test_crops: int = 10,
                 chunk_frames: int = 32, modality: str = "RGB",
                 device="cuda", quantize=False,
                 calibration_frames: Optional[np.ndarray] = None,
                 device_crops: Optional[bool] = None,
                 decode_threads: Optional[int] = None,
                 shared_stem: Optional[bool] = None,
                 prequantized=None, decode_pool=None):
        self.device = resolve_device(device)
        float32_convs_and_matmuls()

        self.model = model.eval()
        self.arch = model.arch
        self.input_spec = input_spec
        self.test_crops = test_crops
        self.chunk_frames = chunk_frames
        self.modality = modality
        self.new_length = model.resolved_new_length
        if device_crops is None:
            device_crops = test_crops == 10
        self.device_crops = device_crops and test_crops == 10
        # the host-crop path's transform; an unsupported crop count raises
        self._transform = (None if self.device_crops else
                           make_test_transform(input_spec.input_size,
                                               input_spec.scale_size,
                                               test_crops))
        self._owns_pool = decode_pool is None
        self._decode_pool = (None if not self.device_crops
                             else make_decode_pool(decode_threads)
                             if decode_pool is None else decode_pool)
        #: frame ticks scored on the device, padding included, and the
        #: real ones among them
        self.device_ticks = 0
        self.real_ticks = 0
        #: the host buffers chunks are built in and copied from
        self.staging = StagingRing(self.device)
        self._graphs = StepGraphs()

        can_share = self.device_crops and supports_shared_stem(self.arch)
        self.shared_stem = bool(shared_stem) and can_share
        if shared_stem and not can_share:
            raise ValueError(
                "shared_stem requires device 10-crop oversampling and a "
                f"supported backbone (got {self.arch!r}, "
                f"device_crops={self.device_crops})")
        self._quantize_mode = ({False: None, None: None, True: "e2e"}
                               .get(quantize, quantize))
        if self._quantize_mode not in (None, "e2e", "perlayer"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if self.shared_stem and self._quantize_mode != "e2e":
            raise ValueError("shared_stem is only wired for the int8-e2e "
                             f"backbone (quantize={quantize!r})")
        if prequantized is not None and not self._quantize_mode:
            raise ValueError("prequantized requires quantize to be set")

        self._quantized = None
        self._act_scales = None
        self._qp = None
        if self._quantize_mode:
            if not supports_int8(self.arch, self._quantize_mode):
                raise ValueError(int8_support_error(self.arch,
                                                    self._quantize_mode))
            calib = (None if calibration_frames is None else
                     torch.as_tensor(np.asarray(calibration_frames),
                                     device=self.device))
            if prequantized is not None:
                # a sibling scorer's export_quantized(): calibration ran once
                q, scales = prequantized
                self._quantized = tree_to(q, self.device)
                if scales is not None:
                    self._act_scales = tree_to(scales, self.device)
            elif self._quantize_mode == "perlayer":
                self._quantized = tree_to(quantize_backbone(
                    model.base_model.state_dict()), self.device)
                if calib is not None:
                    with torch.no_grad():
                        sample = self._prep_calibration(calib)
                    self._act_scales = calibrate_activation_scales(
                        self._quantized, sample)
            else:
                # the float backbone only feeds calibration (host copy)
                self._qp = {k: v.detach().cpu() for k, v in
                            model.base_model.state_dict().items()}
                if calib is not None:
                    self._calibrate(calib)
        else:
            self.model = copy.deepcopy(model).to(self.device)

    def export_quantized(self):
        """``(quantized tree, act_scales or None)`` on the CPU for a sibling
        scorer's ``prequantized=``, or None before calibration has run."""
        if self._quantized is None:
            return None
        scales = (None if self._act_scales is None
                  else tree_to(self._act_scales, "cpu"))
        return tree_to(self._quantized, "cpu"), scales

    @property
    def needs_lazy_calibration(self) -> bool:
        """True while this scorer would calibrate on its next scored chunk."""
        return self._quantize_mode == "e2e" and self._quantized is None

    def install_prequantized(self, export) -> None:
        """Adopt a sibling scorer's :meth:`export_quantized` tree (the
        fan-out shares one lazy calibration: per-device calibration would
        give each device its own scales and device-dependent scores)."""
        if not self._quantize_mode:
            raise ValueError("install_prequantized requires quantize mode")
        q, scales = export
        self._quantized = tree_to(q, self.device)
        if scales is not None:
            self._act_scales = tree_to(scales, self.device)
        self._qp = None

    @property
    def graph_captures(self) -> int:
        """Model steps captured as CUDA graphs (outlives :meth:`close`)."""
        return self._graphs.captures

    @property
    def graph_replays(self) -> int:
        """Chunks scored by a replay (outlives :meth:`close`)."""
        return self._graphs.replays

    def close(self) -> None:
        """Shut down the decode pool it owns, give back the staging slots
        and drop the captured steps (idempotent)."""
        if self._decode_pool is not None and self._owns_pool:
            self._decode_pool.shutdown(wait=False)
        self._decode_pool = None
        self.staging.release()
        self._graphs.steps.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _calibrate(self, frames_u8: torch.Tensor) -> None:
        with torch.no_grad():
            sample = self._prep_calibration(frames_u8)
        self._quantized = tree_to(
            calibrate_e2e_backbone(self.arch, self._qp, sample), self.device)
        self._qp = None    # the host float copy only feeds calibration

    def _prep_calibration(self, frames: torch.Tensor) -> torch.Tensor:
        """Normalized CROP-shaped frames for quantization calibration.

        Scale-size inputs give the first crop offset's normal+flip groups;
        crop-shaped inputs (the host-crop path's) pass through; an oversized
        dim of a smaller frame is center-cropped (see the JAX package's
        ``_prep_calibration``).
        """
        cs = self.input_spec.input_size
        H, W = frames.shape[1], frames.shape[2]
        if H >= cs and W >= cs and not (H == cs and W == cs):
            crops = device_oversample_normed(frames, self.input_spec,
                                             self.modality, self.new_length)
            return crops[: 2 * frames.shape[0]]
        if H > cs:
            o = (H - cs) // 2
            frames = frames[:, o:o + cs]
        if W > cs:
            o = (W - cs) // 2
            frames = frames[:, :, o:o + cs]
        return preprocess_frames(frames, self.input_spec, self.modality,
                                 self.new_length)

    def _chunks(self, samples, provider) -> Iterator[tuple]:
        """Each chunk of ``samples``' ticks on the device, uint8
        ``(chunk_frames, H_scale, W_scale, C)`` scale-size frames (device
        crops) or crop-major ``(test_crops * chunk_frames, crop, crop, C)``
        host crops, with the ``(sample index, tick row)`` of its real rows
        (the module's docstring)."""
        cf = self.chunk_frames
        crops = 1 if self.device_crops else self.test_crops
        for rows, ticks in self._chunk_ticks(samples, provider):
            sp = profiler._is_profiler_enabled and span_begin("chunk.stack")
            slot = self.staging.take((crops * cf,) + ticks[0].shape,
                                     ticks[0].dtype)
            if self.device_crops:
                gather_rows(slot.array, ticks)
                slot.array[len(ticks):] = 0     # a partial chunk's padding
            else:
                slot.array[...] = pad_chunk_ticks(ticks, crops, cf)
            if sp:
                span_end(sp)
            sp = profiler._is_profiler_enabled and span_begin("chunk.h2d")
            frames = self.staging.send(slot)
            if sp:
                span_end(sp)
            self.device_ticks += cf
            self.real_ticks += len(rows)
            yield frames, rows

    def _chunk_ticks(self, samples, provider) -> Iterator[tuple]:
        """Each chunk's real rows and its host frames: a list of scale-size
        ticks, ``samples``' ticks in order, each scale shape's chunk given
        as it fills and the partial ones last; or a sample's crop-major
        host crops of up to ``chunk_frames`` ticks."""
        cf = self.chunk_frames
        if not self.device_crops:
            for si, s in enumerate(samples):
                batches = iter_test_frame_batches(
                    provider, s.video_id, s.frame_ticks, s.num_frames,
                    self._transform, new_length=self.new_length,
                    batch_ticks=cf)
                for lo, batch in zip(range(0, len(s.frame_ticks), cf),
                                     batches):
                    n = batch.shape[0] // self.test_crops
                    yield [(si, lo + r) for r in range(n)], batch
            return
        scale = self.input_spec.scale_size

        def load_one(job) -> np.ndarray:
            s = samples[job[0]]
            return load_scaled_stack(provider, s.video_id, job[2],
                                     s.num_frames, scale, self.new_length)

        jobs = [(si, row, tick) for si, s in enumerate(samples)
                for row, tick in enumerate(s.frame_ticks)]
        decoded = iter_windowed_decode(jobs, load_one, self._decode_pool,
                                       window=4 * cf)
        buffers: Dict[tuple, tuple] = {}        # per scale shape
        for (si, row, _), arr in zip(jobs, decoded):
            rows, ticks = buffers.setdefault(arr.shape, ([], []))
            rows.append((si, row))
            ticks.append(arr)
            if len(ticks) == cf:
                yield rows, ticks
                buffers[arr.shape] = ([], [])
        yield from (b for b in buffers.values() if b[0])    # partial chunks

    def _score_chunk(self, frames_u8: torch.Tensor,
                     n_stacks: int) -> torch.Tensor:
        """A chunk's scores from its uint8 frames on the device: the model
        step, replayed as its chunk key's CUDA graph where it can be (the
        module's docstring)."""
        sp = profiler._is_profiler_enabled and span_begin("chunk.launch")
        if (self.device.type in self.graph_devices
                and self._quantize_mode == "e2e"
                and not self.needs_lazy_calibration):
            scores = self._graphs.run(
                lambda f: self._model_step(f, n_stacks), frames_u8,
                (n_stacks,), lambda: self.graph_factory(self.device))
        else:
            scores = self._model_step(frames_u8, n_stacks)
        if sp:
            span_end(sp)
        return scores

    def _crop_features(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 frames on the device -> ``(test_crops * N, D)`` features,
        crop-major ([o0, o0-flip, o1, ...] blocks of N ticks), calibrating
        first where the int8-e2e backbone still needs it. ``frames_u8`` is
        ``(N, H_scale, W_scale, C)`` with device crops, else the host crops
        ``(test_crops * N, crop, crop, C)``."""
        if self.needs_lazy_calibration:
            self._calibrate(frames_u8)
        qe = self._quantized
        with torch.no_grad():
            if self.shared_stem:
                xn, flip_src = device_normed_pair(
                    frames_u8, self.input_spec, self.modality,
                    self.new_length)
                return int8_e2e_features_sharedstem(
                    self.arch, qe, xn, flip_src, self.input_spec.input_size)
            if self.device_crops:
                x = device_oversample_normed(frames_u8, self.input_spec,
                                             self.modality, self.new_length)
            else:
                x = preprocess_frames(frames_u8, self.input_spec,
                                      self.modality, self.new_length)
            if self._quantize_mode == "perlayer":
                return bninception_int8_features(qe, x, self._act_scales)
            if qe is not None:
                return int8_e2e_features(self.arch, qe, x)
            return self.model.features(x)


def shared_prequantized(make_scorer, use_int8: bool):
    """A scorer factory that builds the first scorer itself (it calibrates,
    or quantizes) and gives every later one its ``export_quantized()``
    tree, under a lock (factories run on the fan-out's threads):
    ``make_scorer(device, prequantized)``."""
    shared = {}
    lock = threading.Lock()

    def factory(device):
        if not use_int8:
            return make_scorer(device, None)
        with lock:
            if "tree" not in shared:
                scorer = make_scorer(device, None)
                # None only when there were no calibration frames (every
                # video empty): nothing calibrates lazily then either
                shared["tree"] = scorer.export_quantized()
                return scorer
            tree = shared["tree"]
        return make_scorer(device, tree)

    return factory


def on_device(device):
    """The context that makes ``device`` this thread's current CUDA device
    (the raw kernel launches go to the current device); nothing for the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def fan_out(scorer_factory, devices: Sequence, items: Iterable,
            score_item: Callable) -> None:
    """Score ``items`` over ``devices``, the scoring CLIs' fan-out: one
    scorer a device (``scorer_factory(device)``, the first one built here)
    and one thread a device, that device current, taking items from one
    queue and calling ``score_item(scorer, item)``; the scorers are closed
    at the end. Threads on one device share its default stream. Under a
    profiler each build is a ``score.build`` span and each item a
    ``score.item`` span, of the item's index in ``items``.

    Lazy calibration election: when the first device's scorer would
    calibrate int8 on its first chunk and there are several devices, this
    thread scores items with it until an export exists (the first item
    with ticks), and every other scorer installs that export before it
    scores; so the scores do not depend on the device count. A factory's
    or a worker's error is raised here."""
    devices = list(devices)
    if not devices:
        raise RuntimeError("no device to score on")
    work: "queue.Queue" = queue.Queue()
    for i, item in enumerate(items):
        work.put((i, item))
    errors: list = []
    lock = threading.Lock()
    shared = {"export": None}

    def next_item():
        try:
            return True, work.get_nowait()
        except queue.Empty:
            return False, None

    def build(device):
        sp = profiler._is_profiler_enabled and span_begin("score.build")
        try:
            return scorer_factory(device)
        finally:
            if sp:
                span_end(sp)

    def score(scorer, job) -> None:
        i, item = job
        sp = profiler._is_profiler_enabled and span_begin("score.item", i)
        try:
            score_item(scorer, item)
        finally:
            if sp:
                span_end(sp)

    def drain(scorer) -> None:
        while not errors:
            more, job = next_item()
            if not more:
                return
            if scorer.needs_lazy_calibration:
                with lock:
                    if shared["export"] is None:
                        # until an export exists, a concurrent score would
                        # calibrate scales of its own
                        score(scorer, job)
                        shared["export"] = scorer.export_quantized()
                        continue
                    scorer.install_prequantized(shared["export"])
            score(scorer, job)

    def worker(device, scorer=None) -> None:
        try:
            with on_device(device):
                if scorer is None:
                    scorer = build(device)
                try:
                    drain(scorer)
                finally:
                    scorer.close()
        except BaseException as e:      # raised on the caller's thread
            with lock:
                errors.append(e)

    with on_device(devices[0]):
        first = build(devices[0])
        try:
            while (len(devices) > 1 and first.needs_lazy_calibration
                   and shared["export"] is None):
                more, job = next_item()
                if not more:
                    break
                score(first, job)
                # a zero-tick video scores no chunk: go on
                shared["export"] = first.export_quantized()
        except BaseException:
            first.close()
            raise
    threads = [threading.Thread(target=worker,
                                args=(d, first if i == 0 else None))
               for i, d in enumerate(devices)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
