"""Plain SSN proposal scoring (Zhao et al., ICCV 2017, arXiv:1704.06228),
from a proposal list and the frames' pixels, on a backbone in float32
(:class:`FloatNet`) or at the precisions a configuration states
(``bn_inception_int8.py``); the heads in float32.

The test protocol of the SSN release: a video of ``n`` frames is sampled
at the frame numbers ``1, 1 + interval, ...`` below ``n - 1``; each
sample is oversampled into 10 crops (5 positions and their mirror
images) and their backbone features are averaged. A proposal is pooled
with the structured temporal pyramid (1, 1, 1): the starting, course and
ending stages, the two outer ones scaled by how much of them lies inside
the video, each the mean of its samples; the activity head reads the
course stage alone, the completeness and regression heads all three. The
regression output is denormalized by the training set's statistics.

Crops follow the shared-stem algorithm that the configuration states: the
stem runs once over a frame and once over its mirror image, and each
crop's window is cut from the stem's stride-8 output at the crop offset
rounded half up to the grid. An int8 backbone is calibrated on the 10
crops of the first sampled frame of 8 videos spread over the list
(:func:`calibration_frames`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import bn_inception, inception_v3
from .quant import IDENTITY
from .resize import scale_shorter_side

ARCHS = {"bn_inception": bn_inception, "inception_v3": inception_v3}


def read_proposal_list(path: str) -> Dict[str, Tuple[int, list]]:
    """``{video: (frames, [(start, end), ...])}`` of a proposal list: groups
    of ``# i``, the video, its duration and fps (frames = their product),
    the ground truth and the proposals ``label iou overlap start end``;
    proposals that are empty or start past the end are dropped, ends are
    cut at the last frame, and a
    video with none is scored as one proposal over the whole video."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    out, i = {}, 0
    while i < len(lines):
        if not lines[i].startswith("#"):
            i += 1
            continue
        vid = lines[i + 1]
        frames = int(float(lines[i + 2]) * float(lines[i + 3]))
        n_gt = int(lines[i + 4])
        j = i + 5 + n_gt
        n_props = int(lines[j])
        props = []
        for row in lines[j + 1:j + 1 + n_props]:
            start, end = (int(v) for v in row.split()[3:5])
            if end > start and start < frames:
                props.append((start, min(end, frames)))
        out[vid] = (frames, props or [(0, frames - 1)])
        i = j + 1 + n_props
    return out


def test_plan(frames: int, props: List[tuple], interval: int):
    """The sampled frame numbers ``(T,)``, each proposal's stage bounds in
    samples ``(P, 4)`` and its outer stages' scalings ``(P, 2)``."""
    ticks = np.arange(0, frames - 1, interval) + 1
    T = len(ticks)
    bounds, scaling = [], []
    for start, end in props:
        a, b = start / frames, end / frames
        half = (b - a) * 0.5
        lo, hi = max(0.0, a - half), min(1.0, b + half)
        scaling.append(((a - lo) / half, (hi - b) / half))
        bounds.append((int(lo * T), int(a * T), int(b * T), int(hi * T)))
    return ticks, np.asarray(bounds, np.int64), np.asarray(scaling,
                                                           np.float32)


def _offsets(width: int, height: int, crop: int):
    ws, hs = (width - crop) // 4, (height - crop) // 4
    return [(0, 0), (4 * ws, 0), (0, 4 * hs), (4 * ws, 4 * hs),
            (2 * ws, 2 * hs)]


class FloatNet:
    """The float32 reference of ``arch`` split for shared-stem scoring,
    each conv's input and weight through the quantizer ``q``."""

    def __init__(self, arch: str, params: dict, q=IDENTITY):
        self.net, self.params, self.q = ARCHS[arch], params, q
        self.stem_hw = self.net.stem_hw

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return self.net.stem(self.params, x, self.q)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        return self.net.trunk(self.params, x, self.q)


def normalized(pixels: np.ndarray, cfg: dict, device) -> torch.Tensor:
    """``(N, H0, W0, 3)`` uint8 RGB frames -> normalized NCHW float32, the
    shorter side scaled to the scale size."""
    frames = np.stack([scale_shorter_side(f, cfg["scale_size"])
                       for f in pixels])
    x = torch.from_numpy(frames).to(device).float()
    if cfg["bgr"]:
        x = x.flip(-1)
    x = (x - torch.tensor(cfg["mean"], device=device)) \
        / torch.tensor(cfg["std"], device=device)
    return x.permute(0, 3, 1, 2)


def oversample(pixels: np.ndarray, cfg: dict, device) -> torch.Tensor:
    """The 10 crops of each frame, frame after frame, each as the five
    positions, every one followed by its mirror image: normalized NCHW
    ``(10 N, 3, crop, crop)`` (TSN's test oversampling)."""
    x = normalized(pixels, cfg, device)
    crop = cfg["crop_size"]
    out = []
    for f in x:
        for ow, oh in _offsets(x.shape[3], x.shape[2], crop):
            c = f[:, oh:oh + crop, ow:ow + crop]
            out += [c, c.flip(2)]
    return torch.stack(out)


def calibration_frames(plan: Dict[str, Tuple[int, list]], interval: int,
                       max_videos: int = 8) -> List[Tuple[str, int]]:
    """``(video, frame number)`` of the int8 calibration frames: the first
    sampled frame of up to ``max_videos`` videos spread evenly over the
    proposal list's order (``linspace`` over the indices, truncated), a
    video without samples replaced by the next one not yet taken."""
    vids = list(plan)
    target = min(max_videos, len(vids))
    spread = list(dict.fromkeys(
        np.linspace(0, len(vids) - 1, target).astype(int).tolist()))
    order = spread + [i for i in range(len(vids)) if i not in set(spread)]
    out = []
    for i in order:
        if len(out) == target:
            break
        ticks = test_plan(*plan[vids[i]], interval)[0]
        if len(ticks):
            out.append((vids[i], int(ticks[0])))
    return out


def frame_features(net, pixels: np.ndarray, cfg: dict, device,
                   batch: int = 0) -> torch.Tensor:
    """``(N, H0, W0, 3)`` uint8 RGB frames -> ``(N, D)`` features of
    ``net`` (:class:`FloatNet`, or a network at the stated precisions),
    the mean over the 10 shared-stem crops of each. ``batch``: frames to
    run the stem on at once, the frames repeated up to it (a bf16 conv's
    rounding can depend on the batch it runs in)."""
    x = normalized(pixels, cfg, device)
    N, _, H, W = x.shape
    if batch > N:
        x = x[torch.arange(batch, device=device) % N]
    crop = cfg["crop_size"]
    with torch.no_grad():
        stems = net.stem(torch.cat([x, x.flip(3)]))
        half = x.shape[0]
        fh, fw, fc = net.stem_hw(H), net.stem_hw(W), net.stem_hw(crop)

        def snap(o: int, lim: int) -> int:
            return min(max(int(o / 8 + 0.5), 0), lim)

        windows = []
        for ow, oh in _offsets(W, H, crop):
            fy, fx = snap(oh, fh - fc), snap(ow, fw - fc)
            mx = snap(W - crop - ow, fw - fc)
            windows.append(stems[:N, :, fy:fy + fc, fx:fx + fc])
            windows.append(stems[half:half + N, :, fy:fy + fc, mx:mx + fc])
        feats = net.trunk(torch.cat(windows))
    return feats.reshape(10, N, -1).mean(dim=0)


def _stage_mean(feats: torch.Tensor, left: int, right: int) -> torch.Tensor:
    T = feats.shape[0]
    lo, hi = min(max(left, 0), T), min(max(right, 0), T)
    if hi <= lo:
        return feats.new_zeros(feats.shape[1])
    return feats[lo:hi].sum(dim=0) / (hi - lo)


def score_video(feats: torch.Tensor, bounds: np.ndarray,
                scaling: np.ndarray, heads: dict, reg_stats: np.ndarray):
    """One video's ``(T, D)`` sample features -> activity ``(P, K+1)``,
    completeness ``(P, K)`` and denormalized regression ``(P, K, 2)``."""
    T = feats.shape[0]
    act_in, comp_in = [], []
    for (t0, t1, t2, t3), (s0, s1) in zip(bounds.tolist(), scaling.tolist()):
        act_in.append(_stage_mean(feats, t1, max(t1 + 1, t2)))
        stages = []
        for (left, right), scale in (((t0, t1), s0), ((t1, t2), 1.0),
                                     ((t2, t3), s1)):
            right = max(left + 1, right)
            if right <= 0 or left >= T:
                stages.append(feats.new_zeros(feats.shape[1]))
            else:
                stages.append(scale * _stage_mean(feats, left, right))
        comp_in.append(torch.cat(stages))
    act_in, comp_in = torch.stack(act_in), torch.stack(comp_in)
    act = act_in @ heads["activity_fc.weight"].t() + heads["activity_fc.bias"]
    comp = (comp_in @ heads["completeness_fc.weight"].t()
            + heads["completeness_fc.bias"])
    reg = (comp_in @ heads["regressor_fc.weight"].t()
           + heads["regressor_fc.bias"]).reshape(len(act), -1, 2)
    stats = torch.as_tensor(reg_stats, dtype=reg.dtype, device=reg.device)
    return act, comp, reg * stats[1] + stats[0]
