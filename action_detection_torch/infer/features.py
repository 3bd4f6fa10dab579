"""The feature step the two scorers share: uint8 frames on the device ->
per-crop backbone features.

:class:`CropFeatureScorer` holds the backbone (float, int8-e2e after
calibration, or per-layer int8), the crop path, the shared-stem choice and
the host decode pool. Two crop paths, as in the JAX package: 10 device
crops (the default: the host ships one scale-size frame a tick and the
oversample is cut on the device), or host crops (``test_crops`` 1, or 10
with ``device_crops=False``: the host cuts them through
``make_test_transform``). :class:`~.scorer.ProposalScorer` (SSN proposal
scoring) means the features over the crops before its fused FC;
:class:`~.actionness.ActionnessScorer` (dense actionness for TAG) keeps
every crop's score. Constructing either turns TF32 off for cuDNN and
matmuls, for parity with the JAX package's float32 convs and
``Precision.HIGHEST`` heads.

Several scorers may score at once, one per device and thread (the
fan-out of ``infer/scorer.py:score_videos`` and ``binary_test``): each
holds its own copy of the weights on its device, the int8 tree comes from
one calibration (``prequantized=``, :meth:`install_prequantized`), and a
decode pool may be shared (``decode_pool=``) so the decode threads stay
``-j`` in all.
"""

from __future__ import annotations

import contextlib
import copy
import queue
import threading
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..data.pipeline import (iter_scaled_frame_chunks,
                             iter_test_frame_batches, make_decode_pool,
                             make_test_transform)
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


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises (the
    port never continues on the CPU in place of a requested GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch sees no CUDA "
                           "device")
    return dev


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
    ``decode_threads``).
    """

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

    def close(self) -> None:
        """Shut down the decode thread pool it owns (idempotent)."""
        if self._decode_pool is not None and self._owns_pool:
            self._decode_pool.shutdown(wait=False)
        self._decode_pool = None

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

    def _frame_chunks(self, sample, provider):
        """One video's uint8 chunks and the crops each tick brings:
        ``(n_ticks, H_scale, W_scale, C)`` scale-size frames and 1 on the
        device-crop path, crop-major ``(test_crops * n_ticks, crop, crop,
        C)`` host crops and ``test_crops`` on the host-crop path."""
        if self.device_crops:
            return iter_scaled_frame_chunks(
                provider, sample.video_id, sample.frame_ticks,
                sample.num_frames, self.input_spec.scale_size,
                new_length=self.new_length, batch_ticks=self.chunk_frames,
                executor=self._decode_pool), 1
        return iter_test_frame_batches(
            provider, sample.video_id, sample.frame_ticks, sample.num_frames,
            self._transform, new_length=self.new_length,
            batch_ticks=self.chunk_frames), self.test_crops

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
