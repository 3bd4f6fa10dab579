"""The scoring path's host spans (``utils/meters.py``), on the CPU.

A seeded TinyConv SSN scores three short videos (15 ticks each at
interval 40: chunks of 4 leave a partial last one) through
``score_videos``, packed and per video, with synchronous decode. Without a
profiler nothing is recorded; under ``torch.profiler.profile`` every span
of the path is, one ``chunk.launch`` a chunk, each chunk's and wait's span
inside its ``score.item`` under the item's index; two CPU "devices" build
their scorers on two threads; the scores are the same bits either way. A
``record_function`` probe inside a span lies within it on the profiler's
clock, and the switch is torch's own flag, off once the profiler exits.
No JAX is imported."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from action_detection_torch.config import SamplingConfig
from action_detection_torch.data.pipeline import SyntheticFrameProvider
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.infer.scorer import ProposalScorer, score_videos
from action_detection_torch.models import SSN, seeded_init
from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.utils.meters import (profiler, span_begin,
                                                 span_end, spans_between)

K = 3
CHUNK = 4
CHUNK_SPANS = ("frames.wait", "chunk.stack", "chunk.h2d", "chunk.launch")
ALL_SPANS = {"score.build", "score.item", "pack.finish", *CHUNK_SPANS}


def write_list(path, n_videos=3, frames=600):
    """A proposal list of ``n_videos`` videos of ``frames`` frames, one
    ground truth and three proposals each."""
    lines = []
    for v in range(n_videos):
        lines.append(f"# {v}\nvideo_{v}\n{frames}\n1\n1\n1 100 300\n3\n"
                     "1 0.8500 0.9000 80 305\n1 0.2000 0.9000 130 210\n"
                     "0 0.0000 0.0000 400 595\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    pf = write_list(tmp_path_factory.mktemp("spans") / "p.txt")
    ds = SSNDataset(pf, SamplingConfig(), test_interval=40)
    model = seeded_init(SSN(num_class=K, base_model="TinyConv",
                            dropout=0.0), seed=3)
    spec = get_backbone("TinyConv")[2]
    reg = np.array([[0.01, -0.02], [0.1, 0.2]], np.float32)
    scorers = []

    def factory(device):
        scorer = ProposalScorer(model, spec, reg_stats=reg, num_class=K,
                                chunk_frames=CHUNK, device=device,
                                decode_threads=1)
        scorers.append(scorer)
        return scorer

    return dict(ds=ds, factory=factory, scorers=scorers,
                provider=SyntheticFrameProvider(width=48, height=40))


def _score(setup, pack, devices=("cpu",), traced=False):
    """``score_videos`` over every video, under the profiler where
    ``traced``: the results, the spans recorded in the call, and the
    call's scorers."""
    first = len(setup["scorers"])
    t0 = time.time_ns()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            out = score_videos(setup["factory"], setup["ds"],
                               setup["provider"], devices=list(devices),
                               pack=pack)
    else:
        out = score_videos(setup["factory"], setup["ds"], setup["provider"],
                           devices=list(devices), pack=pack)
    spans = spans_between(t0, time.time_ns())
    return out, spans, setup["scorers"][first:]


@pytest.mark.parametrize("pack", [False, True])
def test_nothing_is_recorded_without_a_profiler(setup, pack):
    assert not profiler._is_profiler_enabled
    out, spans, _ = _score(setup, pack)
    assert len(out) == 3
    assert spans == []


@pytest.mark.parametrize("pack", [False, True])
def test_every_span_of_the_path_is_recorded(setup, pack):
    out, spans, scorers = _score(setup, pack, traced=True)
    assert len(out) == 3
    assert {s.name for s in spans} == ALL_SPANS
    by_name = {n: [s for s in spans if s.name == n] for n in ALL_SPANS}
    # packed, 45 ticks fill 12 chunks (11 full, one of 1 tick); per video,
    # each 15-tick video takes 4 (3 full, one of 3 ticks)
    chunks = sum(sc.device_ticks for sc in scorers) // CHUNK
    assert chunks == 12
    for name in ("chunk.stack", "chunk.h2d", "chunk.launch"):
        assert len(by_name[name]) == chunks, name
    ticks = sum(sc.real_ticks for sc in scorers)
    assert len(by_name["frames.wait"]) == ticks      # synchronous decode
    items = by_name["score.item"]
    assert sorted(s.item for s in items) == list(range(1 if pack else 3))
    assert len(by_name["pack.finish"]) == (1 if pack else 3)
    assert len(by_name["score.build"]) == 1
    item_of = {s.id: s for s in items}
    for s in spans:
        if s.name in ("score.build", "score.item"):
            assert s.parent is None, s
            continue
        parent = item_of[s.parent]
        assert s.item == parent.item and s.thread == parent.thread, s
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_two_devices_build_on_two_threads(setup):
    out, spans, _ = _score(setup, True, devices=("cpu", "cpu"),
                           traced=True)
    assert len(out) == 3
    builds = [s for s in spans if s.name == "score.build"]
    assert len(builds) == 2
    assert len({s.thread for s in builds}) == 2


@pytest.mark.parametrize("pack", [False, True])
def test_scores_are_the_same_bits_traced(setup, pack):
    plain, _, _ = _score(setup, pack)
    traced, _, _ = _score(setup, pack, traced=True)
    assert set(plain) == set(traced)
    for vid in plain:
        for a, b in zip(plain[vid].as_tuple(), traced[vid].as_tuple()):
            np.testing.assert_array_equal(a, b)


def test_a_profiler_event_inside_a_span_lies_within_it():
    """The spans' clock is the profiler's: a ``record_function`` range
    opened inside a span starts and ends within the span's nanoseconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        sp = span_begin("probe.outer")
        with record_function("probe.inner"):
            torch.ones(64).sum()
        span_end(sp)
    (outer,) = [s for s in spans_between(t0, time.time_ns())
                if s.name == "probe.outer"]
    (inner,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "probe.inner"]
    start = inner.start_ns()
    assert outer.start_ns <= start
    assert start + inner.duration_ns() <= outer.end_ns


def test_the_switch_is_the_profilers_flag():
    """Spans record while a profiler runs and stop with it: a torch
    upgrade that renames or stops setting the flag fails here."""
    assert profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
        t0 = time.time_ns()
        sp = profiler._is_profiler_enabled and span_begin("switch.on")
        if sp:
            span_end(sp)
    assert profiler._is_profiler_enabled is False
    sp = profiler._is_profiler_enabled and span_begin("switch.off")
    assert sp is False
    names = [s.name for s in spans_between(t0, time.time_ns())]
    assert names == ["switch.on"]


def test_threads_record_every_span_under_their_own_parents():
    """Eight threads nest spans at a short switch interval while the
    profiler runs: no append is lost and no parent crosses threads."""
    import sys
    import threading

    n, threads = 200, 8

    def nest(k):
        for _ in range(n):
            outer = span_begin("stress.outer", k)
            span_end(span_begin("stress.inner"))
            span_end(outer)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            t0 = time.time_ns()
            workers = [threading.Thread(target=nest, args=(k,))
                       for k in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    spans = [s for s in spans_between(t0, time.time_ns())
             if s.name.startswith("stress.")]
    assert len(spans) == 2 * n * threads
    outer = {s.id: s for s in spans if s.name == "stress.outer"}
    for s in spans:
        if s.name == "stress.inner":
            parent = outer[s.parent]
            assert (s.thread, s.item) == (parent.thread, parent.item)
