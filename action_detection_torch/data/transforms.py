"""Frame transforms: host crop geometry and device-side normalization (torch).

Port of ``action_detection_tpu/data/transforms.py`` on uint8 arrays:

* **Host**: :func:`fill_fix_offset` (copied as is), :func:`scale_frame` (the
  ``GroupScale`` rule, resizing through :func:`resize_bilinear`, a numpy
  twin of PIL's bilinear resize), :func:`oversample_crops` (the
  ``GroupOverSample`` 10-crop by slicing and flipping, bit-identical to
  PIL's crop + ``FLIP_LEFT_RIGHT``), and the group transforms
  ``GroupScale``, ``GroupCenterCrop``, ``GroupOverSample``,
  ``GroupRandomCrop``,
  ``GroupRandomHorizontalFlip`` (flow-x planes inverted, ``255 - x``), the
  TSN training crops ``GroupMultiScaleCrop`` and ``GroupRandomSizedCrop``
  (a crop is an array slice, the resize :func:`resize_bilinear`, so they
  equal PIL's ``crop`` + ``resize(BILINEAR)`` bit for bit) and ``Compose``,
  with the reference's ``RandomState`` draws in the reference's order;
  :func:`get_train_augmentation` per modality.
* **Device**: normalization, RGBDiff's frame differences
  (:func:`rgb_diff`), the 10-crop oversample of normalized frames and the
  flip-source pair of the shared-stem path, on torch tensors of any
  device. Layout stays NHWC, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch


def fill_fix_offset(more_fix_crop: bool, image_w: int, image_h: int,
                    crop_w: int, crop_h: int) -> List[Tuple[int, int]]:
    """The 5 (or 13) fixed crop anchor offsets of the TSN augmentation."""
    w_step = (image_w - crop_w) // 4
    h_step = (image_h - crop_h) // 4
    ret = [(0, 0), (4 * w_step, 0), (0, 4 * h_step), (4 * w_step, 4 * h_step),
           (2 * w_step, 2 * h_step)]
    if more_fix_crop:
        ret += [(0, 2 * h_step), (4 * w_step, 2 * h_step),
                (2 * w_step, 4 * h_step), (2 * w_step, 0),
                (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step)]
    return ret


_PRECISION_BITS = 22     # Pillow's fixed-point coefficient bits for 8-bit data


@functools.lru_cache(maxsize=64)
def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    triangle filter: per output index the first input index and the
    fixed-point weights ``(out, ksize)`` (zero past each window's end)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0)
             for x in range(xmax)]
        ww = 0.0
        for v in w:        # Pillow's order of the sum
            ww += v
        kk[xx, :xmax] = [v / ww for v in w] if ww != 0.0 else w
        xmins[xx] = xmin
    # round half away from zero into 22 fractional bits
    fixed = np.trunc(kk * (1 << _PRECISION_BITS)
                     + np.where(kk < 0, -0.5, 0.5)).astype(np.int32)
    return xmins, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Pillow's two-pass convolution resize along
    ``axis``: integer sums from ``1 << 21``, shifted and clipped to uint8.
    The triangle filter's weights are non-negative, so every sum fits in
    int32, as in Pillow's own loop."""
    in_size = img.shape[axis]
    xmins, k = _bilinear_coeffs(in_size, out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(k.shape[1]):
        idx = np.minimum(xmins + j, in_size - 1)
        acc += np.take(img, idx, axis=axis) * k[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.resize((width, height), BILINEAR)`` on a uint8 ``(H, W)``
    (mode L) or ``(H, W, C)`` (mode RGB) array, bit-exact with Pillow.

    Pillow's structure: convolution with the triangle filter, whose support
    widens by ``max(1, in/out)``; window ``[int(c - s + 0.5), int(c + s +
    0.5))`` around ``c = (i + 0.5) * in/out``, clamped to the image; weights
    normalized to sum 1, then fixed point with 22 fractional bits; the
    horizontal pass first into a uint8 intermediate, then the vertical pass.
    An axis whose size does not change is not resampled.
    """
    out = img
    if width != img.shape[1]:
        out = _resample_axis(out, width, axis=1)
    if height != img.shape[0]:
        out = _resample_axis(out, height, axis=0)
    return out


def scale_frame(img: np.ndarray, size: int) -> np.ndarray:
    """``GroupScale(size)`` on one ``(H, W)`` or ``(H, W, 3)`` uint8 frame.

    Frames whose smaller edge already equals ``size`` pass through untouched
    (the THUMOS scoring geometry: 340x256 frames at scale size 256). Any
    other size goes through :func:`resize_bilinear`, bit-exact with the
    reference's PIL bilinear resize (InceptionV3's scale size 341).
    """
    h, w = img.shape[:2]
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        return resize_bilinear(img, size, int(size * h / w))
    return resize_bilinear(img, int(size * w / h), size)


def stack_images(imgs) -> np.ndarray:
    """``Stack()``: one ``(H, W, C_total)`` uint8 array from a frame group."""
    if imgs[0].ndim == 2:
        return np.stack(imgs, axis=2)
    return np.concatenate(imgs, axis=2)


def oversample_crops(img_group, crop_size: int,
                     scale_size: Optional[int]) -> List[np.ndarray]:
    """``GroupOverSample(crop_size, scale_size)`` on uint8 arrays.

    Returns the group in the reference order: for each of the 5 offsets,
    every frame cropped, then every frame flipped (gray flow-x planes,
    the even images of a flow group, inverted as ``ImageOps.invert`` does).
    """
    if scale_size:
        img_group = [scale_frame(img, scale_size) for img in img_group]
    image_h, image_w = img_group[0].shape[:2]
    out = []
    for o_w, o_h in fill_fix_offset(False, image_w, image_h, crop_size,
                                    crop_size):
        normal, flipped = [], []
        for i, img in enumerate(img_group):
            crop = img[o_h:o_h + crop_size, o_w:o_w + crop_size]
            normal.append(crop)
            flip = crop[:, ::-1]
            if img.ndim == 2 and i % 2 == 0:
                flip = 255 - flip
            flipped.append(np.ascontiguousarray(flip))
        out.extend(normal)
        out.extend(flipped)
    return out


class GroupScale:
    """Rescale so the smaller edge equals ``size`` (:func:`scale_frame`)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img_group, rng=None):
        return [scale_frame(img, self.size) for img in img_group]


class GroupCenterCrop:
    def __init__(self, size):
        # (height, width), the reference's convention
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img_group, rng=None):
        th, tw = self.size
        out = []
        for img in img_group:
            h, w = img.shape[:2]
            x1 = int(round((w - tw) / 2.0))
            y1 = int(round((h - th) / 2.0))
            out.append(img[y1:y1 + th, x1:x1 + tw])
        return out


class GroupOverSample:
    """The 10-crop test oversample (:func:`oversample_crops`) as a group
    transform."""

    def __init__(self, crop_size: int, scale_size: Optional[int] = None):
        self.crop_size = crop_size
        self.scale_size = scale_size

    def __call__(self, img_group, rng=None):
        return oversample_crops(img_group, self.crop_size, self.scale_size)


class GroupRandomHorizontalFlip:
    """Flip the whole group with p=0.5; invert flow-x images when flipping."""

    def __init__(self, is_flow: bool = False):
        self.is_flow = is_flow

    def __call__(self, img_group, rng: np.random.RandomState):
        if rng.rand() >= 0.5:
            return img_group
        ret = [np.ascontiguousarray(img[:, ::-1]) for img in img_group]
        if self.is_flow:
            for i in range(0, len(ret), 2):
                ret[i] = 255 - ret[i]
        return ret


class GroupRandomCrop:
    """One random ``size`` crop for the whole group (two ``randint`` draws,
    x then y, also when the crop is the whole image)."""

    def __init__(self, size):
        # (height, width), the reference's convention
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img_group, rng: np.random.RandomState):
        h, w = img_group[0].shape[:2]
        th, tw = self.size
        x1 = rng.randint(0, w - tw + 1)
        y1 = rng.randint(0, h - th + 1)
        if (w, h) == (tw, th):
            return list(img_group)
        return [img[y1:y1 + th, x1:x1 + tw] for img in img_group]


def _crop_resize(img_group, x1: int, y1: int, w: int, h: int,
                 out_w: int, out_h: int) -> List[np.ndarray]:
    """PIL's ``crop((x1, y1, x1 + w, y1 + h)).resize((out_w, out_h),
    BILINEAR)`` on every image of the group."""
    return [resize_bilinear(img[y1:y1 + h, x1:x1 + w], out_w, out_h)
            for img in img_group]


class GroupMultiScaleCrop:
    """Fixed-offset multi-scale cropping (the TSN augmentation).

    Crop sides are the smaller edge times one of ``scales`` (snapped to the
    input size within 3 pixels), paired with at most ``max_distort`` steps
    of aspect distortion, placed at one of 13 fixed offsets
    (:func:`fill_fix_offset`) and resized to ``input_size``.
    """

    def __init__(self, input_size, scales=None, max_distort: int = 1,
                 fix_crop: bool = True, more_fix_crop: bool = True):
        self.scales = scales if scales is not None else [1, 0.875, 0.75, 0.66]
        self.max_distort = max_distort
        self.fix_crop = fix_crop
        self.more_fix_crop = more_fix_crop
        self.input_size = ([input_size, input_size]
                           if isinstance(input_size, int) else input_size)

    def __call__(self, img_group, rng: np.random.RandomState):
        h, w = img_group[0].shape[:2]
        crop_w, crop_h, off_w, off_h = self.sample_crop((w, h), rng)
        return _crop_resize(img_group, off_w, off_h, crop_w, crop_h,
                            self.input_size[0], self.input_size[1])

    def sample_crop(self, im_size: Tuple[int, int],
                    rng: np.random.RandomState):
        image_w, image_h = im_size
        base_size = min(image_w, image_h)
        crop_sizes = [int(base_size * s) for s in self.scales]
        crop_h = [self.input_size[1] if abs(x - self.input_size[1]) < 3 else x
                  for x in crop_sizes]
        crop_w = [self.input_size[0] if abs(x - self.input_size[0]) < 3 else x
                  for x in crop_sizes]
        pairs = [(w, h) for i, h in enumerate(crop_h)
                 for j, w in enumerate(crop_w)
                 if abs(i - j) <= self.max_distort]
        crop_pair = pairs[rng.randint(len(pairs))]
        if not self.fix_crop:
            w_off = rng.randint(0, image_w - crop_pair[0] + 1)
            h_off = rng.randint(0, image_h - crop_pair[1] + 1)
        else:
            offsets = fill_fix_offset(self.more_fix_crop, image_w, image_h,
                                      crop_pair[0], crop_pair[1])
            w_off, h_off = offsets[rng.randint(len(offsets))]
        return crop_pair[0], crop_pair[1], w_off, h_off


class GroupRandomSizedCrop:
    """Inception-style random area (0.08-1.0) and aspect (3/4-4/3) crop,
    resized to ``size``; after 10 misses, scale + random crop."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img_group, rng: np.random.RandomState):
        h0, w0 = img_group[0].shape[:2]
        for _ in range(10):
            area = w0 * h0
            target_area = rng.uniform(0.08, 1.0) * area
            aspect_ratio = rng.uniform(3.0 / 4, 4.0 / 3)
            w = int(round(np.sqrt(target_area * aspect_ratio)))
            h = int(round(np.sqrt(target_area / aspect_ratio)))
            if rng.rand() < 0.5:
                w, h = h, w
            if w <= w0 and h <= h0:
                x1 = rng.randint(0, w0 - w + 1)
                y1 = rng.randint(0, h0 - h + 1)
                return _crop_resize(img_group, x1, y1, w, h, self.size,
                                    self.size)
        return GroupRandomCrop(self.size)(GroupScale(self.size)(img_group),
                                          rng)


class Compose:
    """Chain group transforms, threading the shared RandomState through."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img_group,
                 rng: Optional[np.random.RandomState] = None):
        for t in self.transforms:
            img_group = t(img_group, rng)
        return img_group


def get_train_augmentation(input_size: int, modality: str) -> Compose:
    """The reference's per-modality training augmentation (multi-scale crop
    + random flip; Flow inverts its x planes on a flip)."""
    if modality == "RGB":
        return Compose([GroupMultiScaleCrop(input_size, [1, 0.875, 0.75, 0.66]),
                        GroupRandomHorizontalFlip(is_flow=False)])
    if modality == "Flow":
        return Compose([GroupMultiScaleCrop(input_size, [1, 0.875, 0.75]),
                        GroupRandomHorizontalFlip(is_flow=True)])
    if modality == "RGBDiff":
        return Compose([GroupMultiScaleCrop(input_size, [1, 0.875, 0.75]),
                        GroupRandomHorizontalFlip(is_flow=False)])
    raise ValueError(f"unknown modality {modality}")


@functools.lru_cache(maxsize=64)
def _channel_stats(values: tuple, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once: a copy from the host
    cannot be captured into a CUDA graph (``infer/step_graph.py``), so the
    step's warm-up makes it and every captured step reads it."""
    return torch.as_tensor(values, dtype=dtype, device=device)


def normalize_stack(frames: torch.Tensor, mean, std, bgr: bool = False,
                    div255: bool = False, channels_per_image: int = 3,
                    dtype: torch.dtype = None) -> torch.Tensor:
    """Device-side normalization of stacked uint8 frames ``(..., H, W, C)``.

    ``bgr`` reverses the channel order within each image's channel group
    (the Caffe-port ``Stack(roll=True)``). Returns float32 (or ``dtype``).
    """
    dtype = dtype or torch.float32
    x = frames.to(dtype)
    if div255:
        x = x / 255.0
    c_total = x.shape[-1]
    n_img = c_total // channels_per_image
    if bgr and channels_per_image == 3:
        x = x.reshape(x.shape[:-1] + (n_img, channels_per_image))
        x = x.flip(-1)
        x = x.reshape(x.shape[:-2] + (c_total,))
    mean = _channel_stats(tuple(float(v) for v in mean), dtype, x.device)
    std = _channel_stats(tuple(float(v) for v in std), dtype, x.device)
    mean = mean.repeat(c_total // mean.shape[0])
    std = std.repeat(c_total // std.shape[0])
    return (x - mean) / std


def preprocess_frames(frames: torch.Tensor, spec, modality: str = "RGB",
                      new_length: int = 1,
                      dtype: torch.dtype = None) -> torch.Tensor:
    """Device-side preprocessing (NHWC) for any modality.

    RGB/Flow: normalize with the backbone's input statistics. RGBDiff: the
    BGR roll with no mean/std, then the consecutive-frame differences
    (:func:`rgb_diff`; the reference trains RGBDiff with an identity
    normalization), ``3 * (new_length + 1)`` channels in, ``3 *
    new_length`` out."""
    if modality == "RGBDiff":
        x = normalize_stack(frames, (0.0,), (1.0,), bgr=spec.bgr,
                            div255=spec.div255, channels_per_image=3,
                            dtype=dtype)
        return rgb_diff(x, new_length)
    channels = 1 if modality == "Flow" else 3
    return normalize_stack(frames, spec.mean, spec.std, bgr=spec.bgr,
                           div255=spec.div255, channels_per_image=channels,
                           dtype=dtype)


def rgb_diff(frames: torch.Tensor, new_length: int) -> torch.Tensor:
    """Consecutive-frame differences: ``(..., H, W, 3 * (new_length + 1))``
    stacked frames -> ``(..., H, W, 3 * new_length)``."""
    shape = tuple(frames.shape)
    n_frames = shape[-1] // 3
    if n_frames != new_length + 1:
        raise ValueError(f"rgb_diff: {n_frames} frames in the stack, "
                         f"new_length {new_length} needs {new_length + 1}")
    x = frames.reshape(shape[:-1] + (n_frames, 3))
    diffs = x[..., 1:, :] - x[..., :-1, :]
    return diffs.reshape(shape[:-1] + (3 * new_length,))


def device_normed_pair(frames: torch.Tensor, spec, modality: str = "RGB",
                       new_length: int = 1, dtype: torch.dtype = None):
    """Normalized frames + the flip SOURCE tensor.

    ``flip_src`` equals ``xn`` (RGBDiff: the difference tensor, never
    inverted) except for Flow, whose flow-x planes are inverted on flip: the inverted planes are normalized from
    ``255 - frames`` directly, which is elementwise and bit-identical to the
    host path's invert-then-normalize.
    """
    xn = preprocess_frames(frames, spec, modality, new_length, dtype=dtype)
    if modality == "Flow":
        inv = preprocess_frames(255 - frames, spec, modality, new_length,
                                dtype=dtype)
        is_x = (torch.arange(xn.shape[-1], device=xn.device) % 2 == 0)
        flip_src = torch.where(is_x, inv, xn)
    else:
        flip_src = xn
    return xn, flip_src


def device_oversample_normed(frames: torch.Tensor, spec,
                             modality: str = "RGB", new_length: int = 1,
                             crop_size: Optional[int] = None,
                             dtype: torch.dtype = None) -> torch.Tensor:
    """Normalize the N scale-size frames, THEN cut the 10 crops.

    Normalization is elementwise in the pixel value, so it commutes exactly
    with cropping and flipping. Returns ``(10*N, crop, crop, C')`` in the
    ``GroupOverSample`` order [o0, o0-flip, o1, o1-flip, ...].
    """
    crop_size = crop_size or spec.input_size
    xn, flip_src = device_normed_pair(frames, spec, modality, new_length,
                                      dtype=dtype)
    _, H, W, _ = xn.shape
    groups = []
    for o_w, o_h in fill_fix_offset(False, W, H, crop_size, crop_size):
        crop = xn[:, o_h:o_h + crop_size, o_w:o_w + crop_size, :]
        flip = flip_src[:, o_h:o_h + crop_size,
                        o_w:o_w + crop_size, :].flip(2)
        groups.extend((crop, flip))
    out = torch.stack(groups, dim=0)
    return out.reshape((-1,) + tuple(out.shape[2:]))
