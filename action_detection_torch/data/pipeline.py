"""Host input pipeline: frame providers, training batches, the prefetching
loader of the training CLIs, scoring chunks.

Port of ``action_detection_tpu/data/pipeline.py``.
Providers return uint8 numpy arrays, not PIL images: the synthetic provider
makes its pixels with the same ``zlib.crc32`` key and ``RandomState.randint``
draws as the reference, so at the THUMOS scale size (340x256 frames, scale
size 256) the pixels are equal to the JAX package's without PIL; other scale
sizes resize with :func:`~.transforms.scale_frame`, bit-exact with PIL.
Frame files (:class:`DirectoryFrameProvider`: JPEG, PNG, BMP or PNM, by
their first bytes, as PIL sniffs) are decoded by the port's own C++
decoder (:func:`~.image.decode_image`), bit-exact with PIL's
``convert("RGB")`` and ``convert("L")``; the port imports PIL nowhere.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .ssn_dataset import SSNDataset
from .transforms import (Compose, GroupCenterCrop, GroupOverSample,
                         GroupScale, scale_frame, stack_images)


class DirectoryFrameProvider:
    """Loads extracted frames from per-video directories.

    ``image_tmpl``: 'img_{:05d}.jpg' (RGB) or '{}_{:05d}.jpg' (flow, formatted
    with 'x'/'y' + index). A file is read by its first bytes, as PIL's
    ``Image.open`` reads it, whatever its name: JPEG, PNG, BMP (or DIB) and
    PNM (P1-P6) decode (:func:`~.image.decode_image`); any other format PIL
    opens (GIF, TIFF, WebP, ...) raises ``ValueError`` naming the file and
    the format.
    """

    def __init__(self, root: str = "", image_tmpl: str = "img_{:05d}.jpg",
                 modality: str = "RGB"):
        self.root = root
        self.image_tmpl = image_tmpl
        self.modality = modality

    def load(self, video_id: str, idx: int) -> List[np.ndarray]:
        import os

        from .image import decode_image

        directory = os.path.join(self.root, video_id)
        if self.modality in ("RGB", "RGBDiff"):
            return [decode_image(os.path.join(
                directory, self.image_tmpl.format(idx)), "RGB")]
        return [decode_image(os.path.join(
            directory, self.image_tmpl.format(axis, idx)), "L")
            for axis in ("x", "y")]


def frame_template(modality: str, flow_prefix: str = "") -> str:
    """The frame file names of a modality under a video's directory:
    ``img_NNNNN.jpg`` for RGB and RGBDiff, ``<flow_prefix>{x,y}_NNNNN.jpg``
    for Flow."""
    if modality in ("RGB", "RGBDiff"):
        return "img_{:05d}.jpg"
    return flow_prefix + "{}_{:05d}.jpg"


class SyntheticFrameProvider:
    """Deterministic pseudo-random uint8 frames keyed by (video_id, index)."""

    def __init__(self, width: int = 340, height: int = 256,
                 modality: str = "RGB", seed: int = 0):
        self.width = width
        self.height = height
        self.modality = modality
        self.seed = seed

    def load(self, video_id: str, idx: int) -> List[np.ndarray]:
        import zlib

        # stable across processes (builtin hash() is salted per process)
        key = zlib.crc32(f"{self.seed}/{video_id}/{int(idx)}".encode())
        rng = np.random.RandomState(key)
        if self.modality in ("RGB", "RGBDiff"):
            return [rng.randint(0, 256, size=(self.height, self.width, 3),
                                dtype=np.uint8)]
        x = rng.randint(0, 256, size=(self.height, self.width), dtype=np.uint8)
        y = rng.randint(0, 256, size=(self.height, self.width), dtype=np.uint8)
        return [x, y]


def frames_per_segment(modality: str, new_length: int) -> int:
    """Frames fetched per segment: RGBDiff needs new_length+1 raw frames."""
    return new_length + 1 if modality == "RGBDiff" else new_length


def load_proposal_frames(provider, video_id: str, frame_indices: Sequence[int],
                         frame_cnt: int, new_length: int = 1) -> List:
    """Frames for segment starts ``p``: ``min(frame_cnt, p + x)``, x < n."""
    n = frames_per_segment(provider.modality, new_length)
    frames = []
    for p in frame_indices:
        for x in range(n):
            frames.extend(provider.load(video_id,
                                        min(int(frame_cnt), int(p) + x)))
    return frames


def assemble_train_batch(dataset: SSNDataset, video_indices: Sequence[int],
                         provider, augmentation: Callable,
                         rng: np.random.RandomState,
                         random_shift: bool = True) -> Dict[str, np.ndarray]:
    """Build one static-shape uint8 training batch.

    ``augmentation(frames, rng)`` maps one proposal's uint8 frame group to
    its crops (e.g. ``Compose([GroupScale, GroupCenterCrop,
    GroupRandomHorizontalFlip])``). Returns frames (B*P, S, H, W, C) uint8,
    scaling (B*P, 2) f32, labels (B*P,) i64, reg_targets (B*P, 2) f32 and
    prop_type (B*P,) i64.
    """
    all_frames, all_scaling, all_labels, all_reg, all_type = \
        [], [], [], [], []
    S = dataset.body_seg + 2 * dataset.aug_seg
    L = dataset.new_length
    for vi in video_indices:
        sample = dataset.get_training_sample(vi, rng, random_shift=random_shift)
        for i in range(sample.frame_indices.shape[0]):
            vid = sample.frame_video_ids[i]
            frame_cnt = dataset.video_dict[vid].num_frames
            frames = load_proposal_frames(provider, vid,
                                          sample.frame_indices[i], frame_cnt,
                                          L)
            stacked = stack_images(augmentation(frames, rng))
            H, W, c_total = stacked.shape
            # regroup to (S, H, W, C_in): C_in = channels per segment
            all_frames.append(stacked.reshape(H, W, S, c_total // S)
                              .transpose(2, 0, 1, 3))
        all_scaling.append(sample.scaling)
        all_labels.append(sample.labels)
        all_reg.append(sample.reg_targets)
        all_type.append(sample.prop_type)
    return {"frames": np.stack(all_frames).astype(np.uint8),
            "scaling": np.concatenate(all_scaling),
            "labels": np.concatenate(all_labels),
            "reg_targets": np.concatenate(all_reg),
            "prop_type": np.concatenate(all_type)}


def assemble_binary_batch(dataset, video_indices: Sequence[int], provider,
                          transform: Callable, rng: np.random.RandomState,
                          random_shift: bool = True) -> Dict[str, np.ndarray]:
    """One uint8 batch of the binary actionness trainer (the JAX
    ``binary_train``'s ``assemble``): frames (B*P, S, H, W, C), S the course
    segments, and fg/bg labels (B*P,) i64."""
    frames, labels = [], []
    S = dataset.body_seg
    for vi in video_indices:
        s = dataset.get_training_sample(vi, rng, random_shift=random_shift)
        for i in range(s.frame_indices.shape[0]):
            vid = s.frame_video_ids[i]
            imgs = load_proposal_frames(provider, vid, s.frame_indices[i],
                                        dataset.video_dict[vid].num_frames,
                                        dataset.new_length)
            stacked = stack_images(transform(imgs, rng))
            H, W, C = stacked.shape
            frames.append(stacked.reshape(H, W, S, C // S)
                          .transpose(2, 0, 1, 3))
        labels.append(s.labels)
    return {"frames": np.stack(frames).astype(np.uint8),
            "labels": np.concatenate(labels)}


class PrefetchLoader:
    """Background-thread batch producer with a bounded queue.

    ``make_batch(i)`` runs on a pool of ``num_threads`` threads; the
    producer blocks on the bounded hand-off queue (``prefetch`` batches)
    before it submits more work, so a slow consumer holds it back: at most
    ``prefetch + num_threads + 2`` batches are made ahead of the consumer.
    Batches come out in index order. An exception in a worker is raised
    on the consuming thread; it never hangs the epoch. ``batch_seconds[i]``
    is the host time ``make_batch(i)`` took.
    """

    def __init__(self, make_batch: Callable[[int], Dict[str, np.ndarray]],
                 num_batches: int, prefetch: int = 2, num_threads: int = 2):
        self.make_batch = make_batch
        self.num_batches = num_batches
        self.num_threads = max(num_threads, 1)
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.batch_seconds = [0.0] * num_batches
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._started = False

    def _timed(self, i: int):
        t0 = time.perf_counter()
        batch = self.make_batch(i)
        self.batch_seconds[i] = time.perf_counter() - t0
        return batch

    def _produce(self) -> None:
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            try:
                pending = deque()
                for i in range(self.num_batches):
                    pending.append(pool.submit(self._timed, i))
                    while len(pending) > self.num_threads:
                        self.queue.put(pending.popleft().result())
                while pending:
                    self.queue.put(pending.popleft().result())
                self.queue.put(None)
            except BaseException as e:
                # re-raised on the consuming thread, which would otherwise
                # wait for a batch that never comes
                self.queue.put(e)

    def __iter__(self):
        if not self._started:
            self._producer.start()
            self._started = True
        while True:
            item = self.queue.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def make_decode_pool(threads: Optional[int] = None
                     ) -> Optional[ThreadPoolExecutor]:
    """Thread pool for parallel frame decode on the scoring path.

    Returns None for threads <= 1 (synchronous decode).
    """
    import os

    if threads is None:
        threads = min(8, 2 * (os.cpu_count() or 1))
    if threads <= 1:
        return None
    return ThreadPoolExecutor(max_workers=threads)


def iter_windowed_decode(jobs: Sequence, load_one: Callable,
                         executor: Optional[ThreadPoolExecutor],
                         window: int) -> Iterator:
    """Yield ``load_one(job)`` for each job in order, decoding up to ``window``
    jobs ahead on ``executor``. Synchronous when executor is None."""
    if executor is None:
        for job in jobs:
            yield load_one(job)
        return
    futures: dict = {}
    n = len(jobs)
    for j in range(n):
        for k in range(j, min(j + window, n)):
            if k not in futures:
                futures[k] = executor.submit(load_one, jobs[k])
        yield futures.pop(j).result()


def pad_chunk_ticks(chunk: np.ndarray, host_crops: int,
                    batch_ticks: int) -> np.ndarray:
    """Pad a crop-major ``(host_crops * n_ticks, ...)`` chunk to the static
    ``batch_ticks`` tick count (zero ticks appended per crop block)."""
    n_ticks = chunk.shape[0] // host_crops
    if n_ticks == batch_ticks:
        return chunk
    c = chunk.reshape(host_crops, n_ticks, *chunk.shape[1:])
    c = np.pad(c, ((0, 0), (0, batch_ticks - n_ticks))
               + ((0, 0),) * (c.ndim - 2))
    return c.reshape(host_crops * batch_ticks, *chunk.shape[1:])


def load_scaled_stack(provider, video_id: str, tick, frame_cnt: int,
                      scale_size: int, new_length: int = 1) -> np.ndarray:
    """Decode + rescale one tick to a stacked uint8 ``(H_s, W_s, c_in)``."""
    frames = load_proposal_frames(provider, video_id, [tick], frame_cnt,
                                  new_length)
    return stack_images([scale_frame(f, scale_size) for f in frames])


def iter_scaled_frame_chunks(provider, video_id: str, frame_ticks: np.ndarray,
                             frame_cnt: int, scale_size: int,
                             new_length: int = 1, batch_ticks: int = 32,
                             executor: Optional[ThreadPoolExecutor] = None
                             ) -> Iterator[np.ndarray]:
    """Yield uint8 arrays ``(n_ticks, H_s, W_s, C_in)`` of scale-size frames.

    The host only decodes + rescales; the 10-crop oversample happens on the
    device. Per-tick work fans out on ``executor`` with a bounded in-flight
    window so long videos don't pile decoded frames in host RAM.
    """
    def load_one(tick) -> np.ndarray:
        return load_scaled_stack(provider, video_id, tick, frame_cnt,
                                 scale_size, new_length)

    n = len(frame_ticks)
    arrays = iter_windowed_decode(list(frame_ticks), load_one, executor,
                                  window=4 * batch_ticks)
    for lo in range(0, n, batch_ticks):
        yield np.stack([next(arrays) for _ in range(min(batch_ticks, n - lo))])


def make_test_transform(crop_size: int, scale_size: int,
                        test_crops: int) -> Compose:
    """The host-crop test transform: scale + center crop at 1 crop, the
    10-crop oversample at 10; any other count raises, as in the JAX
    package."""
    if test_crops == 1:
        return Compose([GroupScale(scale_size), GroupCenterCrop(crop_size)])
    if test_crops == 10:
        return Compose([GroupOverSample(crop_size, scale_size)])
    raise ValueError(f"unsupported number of crops {test_crops}")


def iter_test_frame_batches(provider, video_id: str, frame_ticks: np.ndarray,
                            frame_cnt: int, transform: Compose,
                            new_length: int = 1, batch_ticks: int = 32
                            ) -> Iterator[np.ndarray]:
    """Yield host-cropped uint8 arrays ``(crops * n_ticks, H, W, C_in)``.

    Crop-major, tick-minor (the transform emits every tick's frames for
    crop 0, then for crop 0 flipped, ...), the layout the scorers reshape
    to ``(crops, n_ticks, ...)``. A tick stacks ``frames_per_segment``
    images (RGBDiff: ``new_length + 1``) of 3 channels, or 2 flow planes
    each.
    """
    n_per_tick = frames_per_segment(provider.modality, new_length)
    c_in = (2 * n_per_tick if provider.modality == "Flow"
            else 3 * n_per_tick)
    for lo in range(0, len(frame_ticks), batch_ticks):
        frames = load_proposal_frames(provider, video_id,
                                      frame_ticks[lo: lo + batch_ticks],
                                      frame_cnt, new_length)
        stacked = stack_images(transform(frames))
        H, W, c_total = stacked.shape
        yield stacked.reshape(H, W, c_total // c_in, c_in) \
            .transpose(2, 0, 1, 3)


def collect_calibration_frames(dataset, provider, transform: Compose,
                               new_length: int = 1,
                               max_videos: int = 8) -> Optional[np.ndarray]:
    """The first tick of up to ``max_videos`` test videos, spread across
    the list, through the test ``transform``
    (:func:`make_test_transform`), for int8 calibration.

    Zero-tick videos are skipped and replaced by the next unseen index;
    returns None when every video is empty. The JAX package's selection
    policy.
    """
    n_vids = len(dataset.video_list)
    if n_vids == 0:
        return None
    target = min(max_videos, n_vids)
    spread = list(dict.fromkeys(
        np.linspace(0, n_vids - 1, target).astype(int).tolist()))
    seen = set(spread)
    order = spread + [i for i in range(n_vids) if i not in seen]
    chunks: List[np.ndarray] = []
    for i in order:
        if len(chunks) == target:
            break
        s = dataset.get_test_sample(i)
        if len(s.frame_ticks) == 0:
            continue
        chunks.append(next(iter_test_frame_batches(
            provider, s.video_id, s.frame_ticks, s.num_frames, transform,
            new_length=new_length, batch_ticks=1)))
    if not chunks:
        return None
    return np.concatenate(chunks, axis=0)
