"""The one generator of scoring traffic: videos, proposal lists and frames
from a mix's parameters (``portbench/traffic/<mix>.json``) and the seed.

A mix fixes the work; the seed only arranges it. ``lengths`` and
``proposals`` are paired lists of one pack group (the scoring CLI's work
item of ``pack_group`` videos): every group holds each length once, with
its proposal count, in an order the seed draws, so every call of a run
and every seed scores the same ticks. The seed also draws the proposals'
positions and the ground truth. The frames are the mix's own, the same
for every seed (the 8 fixture JPEGs differ in how long they take to
decode): ``sequences`` series of shots, each shot a run of one of the 8
fixture frames of ``portbench/data``, ``shot_frames`` long, drawn from
the mix's ``frames_seed``, so that the content changes along a video as a
real one's does; the video of the ``j``-th length reads sequence ``j``
modulo ``sequences``.

Frame sources (``frames`` in the mix): ``jpeg`` links each sequence into a
directory of ``img_NNNNN.jpg`` files and each video's directory to one of
them, read by the port's ``DirectoryFrameProvider`` (its own decoder);
``decoded`` hands the same frames over already decoded, from memory
(:class:`DecodedFrames`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import tempfile
import time
from typing import List

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
FIXTURES = 8
TEMPLATE = "img_{:05d}.jpg"


def fixture_path(k: int, ext: str = "jpg") -> str:
    """The ``k``-th fixture frame (0-based) of ``portbench/data``."""
    return os.path.join(DATA, f"img_{k + 1:05d}.{ext}")


def fixture_pixels() -> np.ndarray:
    """``(8, 256, 340, 3)`` uint8: the fixtures' RGB pixels, decoded once
    when they were committed (PIL)."""
    return np.stack([np.load(fixture_path(k, "npy"))
                     for k in range(FIXTURES)])


@dataclasses.dataclass
class Video:
    vid: str
    frames: int
    sequence: int
    gt: list            # [(label, start, end)]
    props: list         # [(label, iou, overlap, start, end)]

    def ticks(self, interval: int) -> int:
        """Frame ticks the test protocol samples (frame numbers ``1, 1 +
        interval, ...`` below ``frames - 1``)."""
        return len(range(0, self.frames - 1, interval))


@dataclasses.dataclass
class Traffic:
    videos: List[Video]     # the timed videos, group after group
    warmup: Video           # scored once in set-up
    sequences: np.ndarray   # (sequences, max frame + 1) fixture indices
    group: int              # videos a call scores

    def groups(self) -> List[List[int]]:
        """The timed videos' indices, one list a call."""
        n = len(self.videos)
        return [list(range(lo, lo + self.group))
                for lo in range(0, n, self.group)]


def _video(rng, vid: str, frames: int, n_props: int, sequence: int,
           num_class: int) -> Video:
    gt, shortest = [], max(2, min(30, frames // 2))
    for _ in range(int(rng.integers(1, 4))):
        start = int(rng.integers(0, frames - shortest + 1))
        end = min(frames, start + int(rng.integers(
            shortest, max(shortest + 1, frames // 3))))
        gt.append((int(rng.integers(1, num_class + 1)), start, end))
    props = []
    for _ in range(n_props):
        start = int(rng.integers(0, frames - 2))
        dur = int(np.exp(rng.uniform(np.log(10), np.log(frames))))
        end = min(frames, start + max(dur, 2))
        props.append((int(rng.integers(0, num_class + 1)),
                      float(rng.uniform()), float(rng.uniform()),
                      start, end))
    return Video(vid, frames, sequence, gt, props)


def make_traffic(mix: dict, num_class: int, seed: int) -> Traffic:
    """The run's videos and frame sequences from ``mix`` and ``seed``."""
    rng = np.random.default_rng(seed)
    lengths, props = mix["lengths"], mix["proposals"]
    if len(lengths) != len(props):
        raise ValueError("a mix's lengths and proposals pair one to one")
    n_seq = mix["sequences"]
    videos = []
    for g in range(mix["groups"]):
        for j in rng.permutation(len(lengths)):
            videos.append(_video(rng, f"video_{g:03d}_{j:02d}", lengths[j],
                                 props[j], int(j) % n_seq, num_class))
    warmup = _video(rng, "warmup", mix["warmup_frames"], props[0], 0,
                    num_class)
    frames = np.random.default_rng(mix["frames_seed"])
    top = max(max(lengths), mix["warmup_frames"]) + 1
    seqs = np.stack([_shots(frames, top + 1, mix["shot_frames"])
                     for _ in range(n_seq)])
    return Traffic(videos, warmup, seqs, len(lengths))


def _shots(rng, n: int, shot_frames) -> np.ndarray:
    """``n`` fixture indices in shots: runs of one fixture whose lengths
    are log-uniform in ``shot_frames`` ``[lo, hi]``, each a fixture other
    than the one before."""
    lo, hi = shot_frames
    out, at, k = np.empty(n, np.int64), 0, int(rng.integers(FIXTURES))
    while at < n:
        run = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        out[at:at + run] = k
        at += run
        k = (k + int(rng.integers(1, FIXTURES))) % FIXTURES
    return out


def write_proposal_list(path: str, videos: List[Video]) -> None:
    """The proposal-list format of the SSN release (``# i``, video,
    duration, fps 1, ground truth, proposals)."""
    lines = []
    for i, v in enumerate(videos):
        lines.append(f"# {i}\n{v.vid}\n{v.frames}\n1\n{len(v.gt)}\n")
        lines += [f"{lab} {s} {e}\n" for lab, s, e in v.gt]
        lines.append(f"{len(v.props)}\n")
        lines += [f"{lab} {iou:.4f} {ov:.4f} {s} {e}\n"
                  for lab, iou, ov, s, e in v.props]
    with open(path, "w") as f:
        f.writelines(lines)


def link_frames(root: str, traffic: Traffic, cache: str) -> None:
    """``root/<video>/img_NNNNN.jpg`` for every video: each video's
    directory a link to its sequence's directory of links to the fixture
    files. Those are made once, into ``cache`` (a fixed path in the
    checkout, named by a digest of the sequences), and kept: the first run
    of a checkout makes them."""
    digest = hashlib.sha256(traffic.sequences.tobytes()).hexdigest()[:16]
    seq_root = os.path.join(cache, digest)
    if not os.path.isdir(seq_root):
        os.makedirs(cache, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=cache)
        for s, seq in enumerate(traffic.sequences):
            d = os.path.join(tmp, f"sequence{s}")
            os.makedirs(d)
            for i in range(1, len(seq)):
                os.symlink(fixture_path(int(seq[i])),
                           os.path.join(d, TEMPLATE.format(i)))
        try:
            os.rename(tmp, seq_root)
        except OSError:             # another run made it meanwhile
            shutil.rmtree(tmp)
    for v in traffic.videos + [traffic.warmup]:
        os.symlink(os.path.join(seq_root, f"sequence{v.sequence}"),
                   os.path.join(root, v.vid))


class DecodedFrames:
    """A caller's frame provider that already holds every frame decoded:
    ``load`` returns the fixture pixels of the video's sequence at that
    frame number, as the port's ``DirectoryFrameProvider`` returns them."""

    modality = "RGB"

    def __init__(self, traffic: Traffic, pixels: np.ndarray):
        self._seq = {v.vid: traffic.sequences[v.sequence]
                     for v in traffic.videos + [traffic.warmup]}
        self._frames = [p for p in pixels]
        for f in self._frames:
            f.setflags(write=False)

    def load(self, video_id: str, idx: int) -> List[np.ndarray]:
        return [self._frames[int(self._seq[video_id][idx])]]


class TimedProvider:
    """Wraps a provider for the traced run: each ``load`` becomes a span
    ``(start_ns, end_ns)`` on the wall clock the profiler's events use,
    kept in memory."""

    def __init__(self, provider):
        self._provider = provider
        self.modality = provider.modality
        self.spans: list = []       # list.append is atomic: no lock

    def load(self, video_id: str, idx: int):
        t0 = time.time_ns()
        out = self._provider.load(video_id, idx)
        self.spans.append((t0, time.time_ns()))
        return out
