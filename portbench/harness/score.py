"""The scoring job: the port's ``score_videos`` over groups of videos, set
up as its ``ssn_test`` CLI sets it up, timed as a user of that CLI pays for
it, and checked against the plain reference.

Set-up (``setup_s``): the traffic and its frames, the SSN model with
seeded weights made on the device, the calibration frames
(``collect_calibration_frames``), one decode pool of the CLI's default
size, the scorer factory of the CLI (``shared_prequantized``), whose first
scorer calibrates the int8 backbone once, and one warm-up video scored
through ``score_videos``, which runs every shape the window runs (a chunk
has a fixed size). The window: calls of ``score_videos``, one a group of
``pack_group`` videos (the CLI's work item with ``--pack``, which the CLI
turns on for a host of 4 or more cores), started until ``--seconds`` have
passed; each later scorer installs the calibrated tree. The rate is the
ticks of the videos of the calls over the time from the first call's
start to the last call's end.

With ``trace`` the calls run under the profiler (device activity only)
for at most :data:`TRACE_SECONDS`, and the provider is wrapped to record
each frame load; the per-layer metrics read that window.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from typing import Dict, List

import numpy as np
import torch

from . import trace as tr
from .compare import compare_scores
from .traffic import (DecodedFrames, TimedProvider, fixture_pixels,
                      link_frames, make_traffic, write_proposal_list)
from .weights import fit_batch_norm, seeded_reg_stats, seeded_state

#: where the JPEG cells' frame links are kept, under the checkout
FRAME_CACHE = os.path.join("portbench", ".frames")
#: the longest traced window (the profiler's events grow with it)
TRACE_SECONDS = 15.0


@dataclasses.dataclass
class Call:
    videos: List[str]
    ticks: int
    start: float            # perf_counter seconds
    end: float
    start_ns: int           # wall clock, as the profiler's events
    end_ns: int
    results: Dict[str, object]


@dataclasses.dataclass
class ScoreRun:
    """What a run measured, and what the per-layer readers read."""
    config: dict
    calls: List[Call]
    scorers: list = None        # the window's scorers (their counters)
    intervals: list = None      # device events of the traced window
    load_spans: list = None     # (start_ns, end_ns) of each frame load

    @property
    def ticks(self) -> int:
        return sum(c.ticks for c in self.calls)

    @property
    def window_s(self) -> float:
        return self.calls[-1].end - self.calls[0].start

    @property
    def window_ns(self) -> tuple:
        return self.calls[0].start_ns, self.calls[-1].end_ns

    @property
    def busy_s(self) -> float:
        return tr.busy_ns(self.intervals, *self.window_ns) / 1e9

    @property
    def device_ticks(self) -> int:
        return sum(s.device_ticks for s in self.scorers)

    @property
    def real_ticks(self) -> int:
        return sum(s.real_ticks for s in self.scorers)

    @property
    def chunks(self) -> float:
        return self.device_ticks / self.config["chunk_ticks"]


class ScoringJob:
    """One run's set-up, window and check; ``device`` is a torch device."""

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 workdir: str, trace: bool = False):
        from action_detection_torch.config import get_configs
        from action_detection_torch.data.pipeline import (
            DirectoryFrameProvider, collect_calibration_frames,
            make_decode_pool, make_test_transform)
        from action_detection_torch.data.ssn_dataset import SSNDataset
        from action_detection_torch.infer.features import (
            shared_prequantized)
        from action_detection_torch.infer.scorer import (ProposalScorer,
                                                         score_videos)
        from action_detection_torch.models import SSN

        #: seconds each part of the set-up took, in order
        self.phases: Dict[str, float] = {}
        mark = time.perf_counter()

        def phase(name: str) -> None:
            nonlocal mark
            now = time.perf_counter()
            self.phases[name] = now - mark
            mark = now

        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.trace = trace
        self._score_videos = score_videos
        ds = get_configs(config["dataset"])
        self.traffic = make_traffic(mix, config["num_class"], seed)
        self.proposal_list = os.path.join(workdir, "proposal_list.txt")
        write_proposal_list(self.proposal_list,
                            self.traffic.videos + [self.traffic.warmup])
        if mix["frames"] == "jpeg":
            frames = os.path.join(workdir, "frames")
            os.makedirs(frames)
            link_frames(frames, self.traffic, os.path.join(
                os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))), FRAME_CACHE))
            provider = DirectoryFrameProvider(frames, "img_{:05d}.jpg",
                                              "RGB")
        elif mix["frames"] == "decoded":
            provider = DecodedFrames(self.traffic, fixture_pixels())
        else:
            raise ValueError(f"unknown frame source {mix['frames']!r}")
        self.provider = TimedProvider(provider) if trace else provider
        phase("traffic")

        model = SSN(num_class=ds.num_class, modality="RGB",
                    base_model=config["arch"], dropout=0.0,
                    with_regression=True, stpp_cfg=ds.stpp)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.weights = seeded_state(shapes, seed, self.device)
        fit_batch_norm(config, self.weights, self.device)
        model.load_state_dict({k: v.cpu() for k, v in self.weights.items()},
                              strict=False)
        self.reg_stats = seeded_reg_stats(seed)
        phase("weights")
        spec = model.input_spec
        self.dataset = SSNDataset(self.proposal_list, ds.sampling,
                                  new_length=1,
                                  test_interval=config["frame_interval"])
        self._index = {v.id: i for i, v in
                       enumerate(self.dataset.video_list)}
        calibration = collect_calibration_frames(
            self.dataset, self.provider,
            make_test_transform(spec.input_size, spec.scale_size,
                                config["test_crops"]), new_length=1)
        phase("calibration_frames")
        self.pool = make_decode_pool(None)      # the CLI's default -j
        self.scorers: list = []

        def make_scorer(dev, prequantized):
            scorer = ProposalScorer(
                model, spec, reg_stats=self.reg_stats,
                num_class=ds.num_class, stpp_cfg=ds.stpp,
                test_crops=config["test_crops"],
                chunk_frames=config["chunk_ticks"], modality="RGB",
                device=dev, with_regression=True, quantize="e2e",
                calibration_frames=calibration, shared_stem=True,
                prequantized=prequantized, decode_pool=self.pool)
            self.scorers.append(scorer)
            return scorer

        self.factory = shared_prequantized(make_scorer, True)
        self.factory(self.device).close()      # calibrates, once
        phase("calibrate")
        self.pack = (os.cpu_count() or 1) >= 4
        self._call([self.traffic.warmup.vid])  # every shape, once
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        phase("warmup")

    def _call(self, vids: List[str]) -> Call:
        t0, n0 = time.perf_counter(), time.time_ns()
        results = self._score_videos(
            self.factory, self.dataset, self.provider,
            indices=[self._index[v] for v in vids], devices=[self.device],
            pack=self.pack)
        interval = self.config["frame_interval"]
        ticks = sum(v.ticks(interval) for v in self.traffic.videos
                    if v.vid in vids)
        return Call(vids, ticks, t0, time.perf_counter(), n0,
                    time.time_ns(), results)

    def window(self, seconds: float) -> ScoreRun:
        """Calls until ``seconds`` have passed (under the profiler, and
        for at most :data:`TRACE_SECONDS`, when traced)."""
        groups = [[self.traffic.videos[i].vid for i in g]
                  for g in self.traffic.groups()]
        first = len(self.scorers)
        limit = min(seconds, TRACE_SECONDS) if self.trace else seconds
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[
                ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU])     # CPU: the tests' runs
            prof.__enter__()
        calls: List[Call] = []
        try:
            t0 = time.perf_counter()
            while not calls or time.perf_counter() - t0 < limit:
                calls.append(self._call(groups[len(calls) % len(groups)]))
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        run = ScoreRun(self.config, calls,
                       scorers=self.scorers[first:])
        if prof is not None:
            run.intervals = tr.device_intervals(prof)
            run.load_spans = self.provider.spans
        return run

    def close(self) -> None:
        """Stop the decode pool and free what the program holds on the
        device (the reference runs after)."""
        self.pool.shutdown(wait=True)
        self.scorers.clear()
        self.factory = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def end_to_end(self, run: ScoreRun) -> Dict[str, float]:
        """The rate: ticks of the window's calls over their time."""
        return {"score_ticks_per_s": run.ticks / run.window_s}

    @staticmethod
    def host_spans(run: ScoreRun) -> dict:
        """The harness's host spans by name, for labelling idle gaps."""
        return {"provider.load": run.load_spans or [],
                "score_videos": [(c.start_ns, c.end_ns) for c in run.calls]}

    @staticmethod
    def attempted(run: ScoreRun) -> int:
        return sum(len(c.videos) for c in run.calls)

    @staticmethod
    def failed(run: ScoreRun, checks: dict) -> int:
        return int(checks["videos_missing"]["value"])

    def check(self, run: ScoreRun) -> dict:
        """The numbers that decide ``correct``, each with its limit: the
        widest relative gap of a sampled video's scores from the
        reference's (``score_gap``, the configuration's limit), and the
        videos of the completed calls that came back without scores
        (limit 0)."""
        missing = sum(1 for c in run.calls for v in c.videos
                      if v not in c.results)
        scored = [(i, v) for i, c in enumerate(run.calls)
                  for v in c.videos if v in c.results]
        gap = compare_scores(self, run, scored, self.mix["compare_videos"])
        return {"score_gap": {"value": gap,
                              "limit": self.config["limits"]["score_gap"]},
                "videos_missing": {"value": float(missing), "limit": 0.0}}
