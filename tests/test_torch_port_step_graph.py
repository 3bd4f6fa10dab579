"""The scorers' model step as a CUDA graph (``infer/features.py:
CropFeatureScorer._score_chunk``, ``infer/step_graph.py:StepGraphs``).

On the CPU a fake graph (``CropFeatureScorer.graph_factory``, the seam the
scorers make their graphs through) records each call: its capture runs
the step once and leaves NaN in the static output, as a real capture
computes nothing, and its replay runs the step again into that output. A
seeded BNInception SSN at 64^2 crops (int8-e2e, the shared stem) scores
two videos of 8 ticks in chunks of 3, one video at another scale shape:
two chunk keys, a partial last chunk each; so does a seeded BNInception
actionness classifier, video by video. The first chunk of a key runs
eagerly, the second captures and replays, later ones replay; the scores
and the actionness logits equal the eager ones bit for bit (so the static
input is refreshed and each chunk's output is a clone); a scorer that
calibrates lazily captures nothing before its calibration; each key
captures once; the counters count and outlive ``close``, which drops the
graphs; ``launch_counts()`` grows by a capture's launches on each replay,
and a capture's tally holds none of another thread's launches; the CPU,
``perlayer`` and float scorers of either kind never capture.
``graph_replay_share.score`` reads the counters.

The cases marked ``cuda`` run the real graphs on the card and skip here:
graph and eager scores of a packed call, and graph and eager actionness
logits, are bit-identical, the harness's planted faults still change the
scores under replay, and the peak memory, the reserved memory and the
graph pool of the 5th of 5 calls equal the 2nd's. The file imports no
JAX:

    python -m pytest tests/test_torch_port_step_graph.py -m cuda
"""

import gc
import importlib.util
import json
import math
import os
import threading
import weakref
from dataclasses import astuple

import numpy as np
import pytest
import torch

from action_detection_torch.config import SamplingConfig
from action_detection_torch.data.binary_dataset import BinaryTestSample
from action_detection_torch.data.pipeline import SyntheticFrameProvider
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.infer.actionness import (ActionnessScorer,
                                                     score_actionness)
from action_detection_torch.infer.features import (CropFeatureScorer,
                                                   shared_prequantized)
from action_detection_torch.infer.scorer import ProposalScorer, score_videos
from action_detection_torch.kernels import (CONCATS, KERNELS,
                                            add_launch_counts,
                                            concat_counts, count_launch,
                                            launch_counts,
                                            reset_launch_counts)
from action_detection_torch.kernels.int8 import int8_conv
from action_detection_torch.models import SSN, BinaryClassifier, seeded_init
from action_detection_torch.models.backbones import InputSpec, get_backbone
from action_detection_torch.utils.native import gather_rows

from tests.test_torch_port_spans import write_list

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3
CHUNK = 3
TALL = "video_1"
REG = np.array([[0.01, -0.02], [0.1, 0.2]], np.float32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch CPU thread a test (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TwoShapes:
    """Synthetic frames, 80x72 but for :data:`TALL`'s, at 72x80: two scale
    shapes at the 64^2 spec."""

    modality = "RGB"

    def __init__(self):
        self.wide = SyntheticFrameProvider(width=80, height=72)
        self.tall = SyntheticFrameProvider(width=72, height=80)

    def load(self, vid, idx):
        return (self.tall if vid == TALL else self.wide).load(vid, idx)


class FakeGraph:
    """A CUDA graph's stand-in on the CPU; appends ``(event, self)`` to
    ``log`` for each make, capture and replay."""

    def __init__(self, log, device):
        self.log, self.device = log, device
        self.out = None
        log.append(("make", self))

    def capture(self, step):
        self.step = step
        self.out = step()
        self.out.fill_(math.nan)         # a capture computes nothing
        self.log.append(("capture", self))
        return self.out

    def replay(self):
        counts = launch_counts()
        counts.update(concat_counts())
        out = self.step()
        for name, n in counts.items():   # a replay launches from no Python
            counter = KERNELS.get(name) or CONCATS.get(name)
            if counter is not None:
                counter.launches = n
        self.out.copy_(out)
        self.log.append(("replay", self))


def one_chunk(dtype=torch.uint8):
    """A chunk of :data:`CHUNK` scale-size frames of the wide shape."""
    provider = SyntheticFrameProvider(width=81, height=73)
    return torch.from_numpy(np.stack(
        [provider.load("video_0", i)[0] for i in range(CHUNK)])).to(dtype)


def fake_factory(monkeypatch, check=None, graph=FakeGraph, on_cpu=True):
    """Make the scorers' graphs ``graph`` s (:class:`FakeGraph` s), on the
    CPU too unless not ``on_cpu``; returns their log. ``check(device)``
    runs before each is made."""
    log = []

    def factory(device):
        if check is not None:
            check(device)
        return graph(log, device)

    monkeypatch.setattr(CropFeatureScorer, "graph_factory",
                        staticmethod(factory))
    if on_cpu:
        monkeypatch.setattr(CropFeatureScorer, "graph_devices", ("cpu",))
    return log


def events(log):
    return [e for e, _ in log]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    pf = write_list(tmp_path_factory.mktemp("step_graph") / "p.txt",
                    n_videos=2, frames=300)
    ds = SSNDataset(pf, SamplingConfig(), test_interval=40)
    model = seeded_init(SSN(num_class=K, dropout=0.0), seed=4)
    base = get_backbone("BNInception")[2]
    spec = InputSpec(64, base.mean, base.std, base.bgr, base.div255)
    provider = TwoShapes()
    calib = one_chunk().numpy()[:2]
    samples = [ds.get_test_sample(i) for i in range(len(ds.video_list))]

    def make(quantize="e2e", calibrate=True, **kw):
        if quantize == "e2e":
            kw.setdefault("shared_stem", True)
        return ProposalScorer(model, spec, reg_stats=REG, num_class=K,
                              chunk_frames=CHUNK, device="cpu",
                              quantize=quantize, decode_threads=1,
                              calibration_frames=calib if calibrate
                              else None, **kw)

    binary = seeded_init(BinaryClassifier(dropout=0.0), seed=4)

    def make_actionness(quantize="e2e", calibrate=True):
        return ActionnessScorer(binary, spec, chunk_frames=CHUNK,
                                device="cpu", quantize=quantize,
                                shared_stem=quantize == "e2e",
                                decode_threads=1,
                                calibration_frames=calib if calibrate
                                else None)

    bsamples = [BinaryTestSample(s.video_id, s.frame_ticks, s.num_frames)
                for s in samples]
    with make() as eager:
        ref = eager.score_video_pack(samples, provider, keep_raw=True)
    with make_actionness() as eager:
        bref = [eager.score_video(s, provider) for s in bsamples]
    assert [len(s.frame_ticks) for s in samples] == [8, 8]
    return dict(make=make, samples=samples, provider=provider, ref=ref,
                model=model, spec=spec, make_actionness=make_actionness,
                bsamples=bsamples, bref=bref)


def score_all(setup, scorer, kind, **kw):
    """A packed proposal call, or the actionness scorer's per-video
    calls."""
    if kind == "proposal":
        return scorer.score_video_pack(setup["samples"], setup["provider"],
                                       **kw)
    return [scorer.score_video(s, setup["provider"])
            for s in setup["bsamples"]]


def assert_equal_scores(got, ref):
    for g, r in zip(got, ref):
        for a, b in zip(astuple(g)[1:], astuple(r)[1:]):
            np.testing.assert_array_equal(a, b)


def test_first_chunk_eager_second_captures_later_replay(setup, monkeypatch):
    """Chunks of one key: the first runs eagerly (no graph made), the
    second captures and replays, the third replays."""
    log = fake_factory(monkeypatch)
    scorer = setup["make"]()
    frames = one_chunk()
    eager = scorer._model_step(frames, CHUNK)
    out = scorer._score_chunk(frames, CHUNK)
    assert log == [] and scorer.graph_captures == scorer.graph_replays == 0
    torch.testing.assert_close(out, eager, rtol=0, atol=0)
    for n in (1, 2):
        out = scorer._score_chunk(frames, CHUNK)
        torch.testing.assert_close(out, eager, rtol=0, atol=0)
        assert (scorer.graph_captures, scorer.graph_replays) == (1, n)
    assert events(log) == ["make", "capture", "replay", "replay"]
    scorer.close()


@pytest.mark.parametrize("kind", ["proposal", "actionness"])
def test_packed_call_equals_eager_bit_for_bit(setup, monkeypatch, kind):
    """Every chunk is copied into the static input before its replay and
    comes back as a clone: a packed call (two keys, each with a partial
    chunk) gives the eager scores, and the actionness scorer's two videos
    (the same keys) its eager logits, with 2 captures and 4 replays of 6
    chunks."""
    log = fake_factory(monkeypatch)
    scorer = setup["make" if kind == "proposal" else "make_actionness"]()
    returned = []
    score = scorer._score_chunk

    def spy(frames_u8, n_stacks):
        out = score(frames_u8, n_stacks)
        returned.append(out)
        return out

    scorer._score_chunk = spy
    if kind == "proposal":
        got = score_all(setup, scorer, kind, keep_raw=True)
        assert_equal_scores(got, setup["ref"])
    else:
        for g, r in zip(score_all(setup, scorer, kind), setup["bref"]):
            assert g.shape == (8, 10, 2)
            np.testing.assert_array_equal(g, r)
    assert scorer.device_ticks == 6 * CHUNK
    assert (scorer.graph_captures, scorer.graph_replays) == (2, 4)
    graphs = [g for e, g in log if e == "make"]
    outs = {g.out.data_ptr() for g in graphs}
    assert not any(o.data_ptr() in outs for o in returned)
    # the scores of a chunk stay as returned after later replays
    assert not any(torch.isnan(o).any() for o in returned)
    scorer.close()


def test_each_key_captures_once(setup, monkeypatch):
    """Two scale shapes and a second dtype at one of them: one capture a
    key, none made again on a second call."""
    log = fake_factory(monkeypatch)
    scorer = setup["make"]()
    scorer.score_video_pack(setup["samples"], setup["provider"])
    scorer.score_video_pack(setup["samples"], setup["provider"])
    graphs = [g for e, g in log if e == "make"]
    assert len(graphs) == scorer.graph_captures == 2
    assert scorer.graph_replays == 12 - 2
    for dtype in (torch.uint8, torch.float32, torch.float32,
                  torch.float32):
        scorer._score_chunk(one_chunk(dtype), CHUNK)
    graphs = [g for e, g in log if e == "make"]
    assert len(graphs) == scorer.graph_captures == 3
    assert set(scorer._graphs.steps) == {
        ((CHUNK, 73, 81, 3), torch.uint8, CHUNK),
        ((CHUNK, 81, 73, 3), torch.uint8, CHUNK),
        ((CHUNK, 73, 81, 3), torch.float32, CHUNK)}
    scorer.close()


def test_lazy_calibration_captures_nothing_before_it(setup, monkeypatch):
    """A scorer without calibration frames calibrates on its first chunk:
    no graph is made until it has, and the first chunk after it warms up
    (eager) before the capture."""
    holder = {}

    def calibrated(device):
        assert not holder["scorer"].needs_lazy_calibration

    log = fake_factory(monkeypatch, calibrated)
    scorer = holder["scorer"] = setup["make"](calibrate=False)
    assert scorer.needs_lazy_calibration
    frames = one_chunk()
    scorer._score_chunk(frames, CHUNK)
    assert not scorer.needs_lazy_calibration and not log
    scorer._score_chunk(frames, CHUNK)           # the warm-up
    assert not log and scorer.graph_captures == 0
    scorer._score_chunk(frames, CHUNK)
    assert events(log) == ["make", "capture", "replay"]
    scorer.close()


def test_counters_count_and_outlive_close(setup, monkeypatch):
    log = fake_factory(monkeypatch)
    scorer = setup["make"]()
    assert (scorer.graph_captures, scorer.graph_replays) == (0, 0)
    scorer.score_video_pack(setup["samples"], setup["provider"])
    assert (scorer.graph_captures, scorer.graph_replays) == (2, 4)
    scorer.score_video(setup["samples"][0], setup["provider"])
    # a per-video call: 3 chunks of the first key, every one a replay
    assert (scorer.graph_captures, scorer.graph_replays) == (2, 7)
    scorer.close()
    assert (scorer.graph_captures, scorer.graph_replays) == (2, 7)
    assert events(log).count("make") == 2


def test_close_drops_the_graphs(setup, monkeypatch):
    """``close`` lets go of every graph and forgets every key: a scorer
    used again warms up and captures anew."""
    log = fake_factory(monkeypatch)
    scorer = setup["make"]()
    scorer.score_video_pack(setup["samples"], setup["provider"])
    graphs = [weakref.ref(g) for e, g in log if e == "make"]
    log.clear()
    scorer.close()
    gc.collect()
    assert len(graphs) == 2 and all(g() is None for g in graphs)
    assert not scorer._graphs.steps
    scorer.close()
    got = scorer.score_video_pack(setup["samples"], setup["provider"],
                                  keep_raw=True)
    assert_equal_scores(got, setup["ref"])
    assert (scorer.graph_captures, scorer.graph_replays) == (4, 8)
    assert [events(log).count(e) for e in ("make", "capture", "replay")
            ] == [2, 2, 4]
    scorer.close()


def test_replays_count_the_captured_launches(setup, monkeypatch):
    """A step standing for one that launches 2 K1s (and a host gather,
    which no capture holds): the capture tallies the K1 launches and the
    trunk's 10 in-place concats (counted on the CPU too), not the gather,
    and each replay adds them to the counters, so K1 counts 2 a chunk as
    eager chunks do."""
    log = fake_factory(monkeypatch)
    features = ProposalScorer._crop_features

    def launching(self, frames_u8):
        count_launch(int8_conv)
        count_launch(int8_conv)
        gather_rows.launches += 1
        return features(self, frames_u8)

    monkeypatch.setattr(ProposalScorer, "_crop_features", launching)
    scorer = setup["make"]()
    reset_launch_counts()
    scorer.score_video_pack(setup["samples"], setup["provider"])
    counts = launch_counts()
    assert counts["int8_conv"] == 2 * 6
    # 6 chunks' gathers, the 2 eager steps' and the 2 captures' stand-ins
    assert counts["host_gather_rows"] == 6 + 4
    assert [s.launches for s in scorer._graphs.steps.values()] == [
        {"int8_conv": 2, "concat_in_place": 10}] * 2
    assert concat_counts()["concat_in_place"] == 10 * 6
    assert events(log).count("replay") == 4
    scorer.close()


class BesideAnotherThread(FakeGraph):
    """A fake graph whose capture lets another thread launch K1 5 times in
    the middle of the step, as a second scorer's eager chunk would."""

    def capture(self, step):
        def beside():
            other = threading.Thread(
                target=lambda: [count_launch(int8_conv) for _ in range(5)])
            other.start()
            other.join()
            return step()

        out = super().capture(beside)
        self.step = step
        return out


def test_capture_tallies_only_its_own_threads_launches(setup, monkeypatch):
    """Three chunks of a step that launches 2 K1s, the second's capture
    beside another thread's 5: the capture tallies its own 2 only (and its
    trunk's 10 concats), and the counter ends at 2 a chunk plus the other
    thread's 5."""
    log = fake_factory(monkeypatch, graph=BesideAnotherThread)
    features = ProposalScorer._crop_features

    def launching(self, frames_u8):
        count_launch(int8_conv)
        count_launch(int8_conv)
        return features(self, frames_u8)

    monkeypatch.setattr(ProposalScorer, "_crop_features", launching)
    scorer = setup["make"]()
    frames = one_chunk()
    reset_launch_counts()
    for _ in range(3):
        scorer._score_chunk(frames, CHUNK)
    assert events(log) == ["make", "capture", "replay", "replay"]
    (step,) = scorer._graphs.steps.values()
    assert step.launches == {"int8_conv": 2, "concat_in_place": 10}
    assert launch_counts()["int8_conv"] == 3 * 2 + 5
    scorer.close()


def test_counts_from_threads_add_up():
    """Launches counted and replays' tallies added from four threads at
    once: the counter holds every one."""
    reset_launch_counts()

    def work():
        for _ in range(5000):
            count_launch(int8_conv)
            add_launch_counts({"int8_conv": 3})

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert launch_counts()["int8_conv"] == 4 * 5000 * 4
    reset_launch_counts()


@pytest.mark.parametrize("scorer_kind", ["proposal", "actionness"])
@pytest.mark.parametrize("kind", ["cpu", "perlayer", "float"])
def test_cpu_perlayer_and_float_never_capture(setup, monkeypatch, kind,
                                              scorer_kind):
    """The CPU runs no CUDA graphs; ``perlayer`` and the float backbone
    stay eager on a device that does."""
    make = setup["make" if scorer_kind == "proposal" else "make_actionness"]
    if kind == "cpu":
        assert CropFeatureScorer.graph_devices == ("cuda",)
        log = fake_factory(monkeypatch, on_cpu=False)
        scorer = make()
    else:
        log = fake_factory(monkeypatch)
        scorer = make(quantize=False if kind == "float" else kind)
    score_all(setup, scorer, scorer_kind)
    assert not log
    assert (scorer.graph_captures, scorer.graph_replays) == (0, 0)
    scorer.close()


def _reader():
    path = os.path.join(ROOT, "portbench", "metrics",
                        "graph_replay_share.score.py")
    spec = importlib.util.spec_from_file_location("graph_replay_share",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class _Run:
    def __init__(self, scorers):
        self.scorers = scorers

    @property
    def chunks(self):
        return sum(s.device_ticks for s in self.scorers or ()) / CHUNK


class _OldScorer:
    device_ticks, real_ticks = 64, 60


def test_graph_replay_share_reader(setup, monkeypatch):
    read = _reader()
    assert read(_Run([])) is None
    assert read(_Run(None)) is None
    # scorers without the counter (the program before the graphs)
    assert read(_Run([_OldScorer(), _OldScorer()])) is None
    fake_factory(monkeypatch)
    scorers = [setup["make"](), setup["make"]()]
    assert read(_Run(scorers)) is None              # nothing scored yet
    scorers[0].score_video_pack(setup["samples"], setup["provider"])
    scorers[1].score_video(setup["samples"][0], setup["provider"])
    for s in scorers:
        s.close()
    # 4 replays of 6 chunks, and 2 of 3
    assert read(_Run(scorers)) == pytest.approx(100.0 * 6 / 9)
    assert read(_Run(scorers + [_OldScorer()])) is None


def test_graph_replay_share_entry():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "graph_replay_share.score"]
    assert entry == {"name": "graph_replay_share.score", "unit": "%",
                     "better": "higher", "source": "program_counter",
                     "layer": "model step", "moves": "score_ticks_per_s",
                     "workloads": ["bni_thumos14.score_decoded"]}
    # appended after the 15 metrics it found (later ones follow it)
    assert bench["per_layer"].index(entry) == 15
    layers = {m["name"]: m["layer"] for m in bench["per_layer"]}
    assert layers["launch_ms.score"] == entry["layer"]


# --- on the card ----------------------------------------------------------


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    """A seeded BNInception SSN at its published 224^2 crops of 340x256
    frames, int8-e2e with the shared stem: three videos of 15 ticks
    scored packed in chunks of 8 (6 chunks, the last one partial: one
    eager, five replays); and a seeded BNInception actionness classifier
    the same way, video by video (6 chunks of one key, 2 a video)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the model step's graphs hold the "
                    "CUDA kernels K1-K3, which have no CPU mode")
    pf = write_list(tmp_path_factory.mktemp("step_graph_cuda") / "p.txt",
                    n_videos=3, frames=600)
    ds = SSNDataset(pf, SamplingConfig(), test_interval=40)
    model = seeded_init(SSN(num_class=K, dropout=0.0), seed=4)
    spec = get_backbone("BNInception")[2]
    provider = SyntheticFrameProvider()
    calib = np.stack([provider.load("video_0", 1)[0][16:240, 58:282]] * 2)

    def make_scorer(device, prequantized):
        return ProposalScorer(model, spec, reg_stats=REG, num_class=K,
                              chunk_frames=8, device=device,
                              quantize="e2e", shared_stem=True,
                              calibration_frames=calib,
                              prequantized=prequantized, decode_threads=2)

    binary = seeded_init(BinaryClassifier(dropout=0.0), seed=4)

    def make_actionness(device, prequantized):
        return ActionnessScorer(binary, spec, chunk_frames=8, device=device,
                                quantize="e2e", shared_stem=True,
                                calibration_frames=calib,
                                prequantized=prequantized, decode_threads=2)

    return dict(ds=ds, provider=provider, make_scorer=make_scorer,
                make_actionness=make_actionness)


def _score(card, factory=None, kind="proposal"):
    """A packed ``score_videos`` call on the card (``score_actionness``
    for the actionness scorer), with a scorer factory of its own; its
    tuples (logits) by video and the scorers it built."""
    built = []
    made = card["make_scorer" if kind == "proposal" else "make_actionness"]

    def make(device, prequantized):
        built.append(made(device, prequantized))
        return built[-1]

    factory = factory or shared_prequantized(make, True)
    if kind == "actionness":
        out = score_actionness(factory, card["ds"], card["provider"],
                               devices=["cuda"])
        return {v: (r,) for v, r in out.items()}, built
    out = score_videos(factory, card["ds"], card["provider"],
                       devices=["cuda"], pack=True)
    return {v: r.as_tuple() for v, r in out.items()}, built


def _eager(monkeypatch):
    monkeypatch.setattr(CropFeatureScorer, "graph_devices", ())


def _assert_same(a, b):
    assert set(a) == set(b) and len(a) == 3
    for vid in a:
        for x, y in zip(a[vid], b[vid]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["proposal", "actionness"])
def test_cuda_graph_scores_equal_eager_bit_for_bit(card, monkeypatch, kind):
    graph, built = _score(card, kind=kind)
    assert [(s.graph_captures, s.graph_replays) for s in built] == [(1, 5)]
    reset_launch_counts()
    again, _ = _score(card, kind=kind)
    graphed_counts = launch_counts()
    _eager(monkeypatch)
    reset_launch_counts()
    eager, built = _score(card, kind=kind)
    assert [(s.graph_captures, s.graph_replays) for s in built] == [(0, 0)]
    _assert_same(graph, eager)
    _assert_same(again, eager)
    # the replays count the launches the card ran, as eager launches do
    assert launch_counts() == graphed_counts


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["half_crops", "half_ticks"])
def test_cuda_faults_still_change_the_scores_under_replay(card, monkeypatch,
                                                          fault):
    from portbench.harness.faults import FAULTS

    clean, _ = _score(card)
    FAULTS[fault](monkeypatch.setattr)
    faulty, built = _score(card)
    assert built[0].graph_replays == 5
    assert any(not np.array_equal(x, y) for vid in clean
               for x, y in zip(clean[vid], faulty[vid]))
    _eager(monkeypatch)
    faulty_eager, _ = _score(card)
    _assert_same(faulty, faulty_eager)


def _private_pools():
    """Bytes the caching allocator holds in each private pool (the graphs'),
    by pool id."""
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg["segment_pool_id"])
        if pool != (0, 0):
            pools[pool] = pools.get(pool, 0) + seg["total_size"]
    return pools


@pytest.mark.cuda
def test_cuda_graph_pools_are_freed_call_to_call(card):
    """Five calls, a scorer each: the peak allocated and the memory
    reserved after the 5th equal the 2nd's, and every call's graph
    captures into the device's one pool, which holds as much after the 5th
    as after the 2nd."""
    peaks, reserved, pools = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, built = _score(card)
        assert built[0].graph_replays == 5
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        reserved.append(torch.cuda.memory_reserved())
        pools.append(_private_pools())
    assert peaks[4] == peaks[1], peaks
    assert reserved[4] == reserved[1], reserved
    assert len(pools[1]) == 1 and pools[4] == pools[1], pools


@pytest.mark.cuda
@pytest.mark.parametrize("arch,hw,concats", [("BNInception", 28, 10),
                                             ("InceptionV3", 35, 15)])
def test_cuda_captured_trunk_assembles_in_place(arch, hw, concats):
    """An int8 trunk whose modules are assembled in place, captured as a
    CUDA graph into the device's pool, replays bit for bit as its eager
    walk (two inputs), which equals the plain kernels on the CPU; the
    capture tallies its in-place concats, which each replay counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trunk's kernels K1-K3 have no "
                    "CPU mode")
    from action_detection_torch.infer.step_graph import CudaStepGraph
    from action_detection_torch.kernels import tally_launches
    from action_detection_torch.models.backbones import (
        bn_inception_int8 as bq)
    from action_detection_torch.models.backbones import (
        inception_v3_int8 as iq)

    model, _, spec = get_backbone(arch, "RGB")
    sd = seeded_init(model, seed=4).state_dict()
    rng = np.random.RandomState(4)
    crops = torch.from_numpy((rng.rand(2, spec.input_size, spec.input_size,
                                       3) * 255.0 - 117.0).astype(np.float32))
    if arch == "BNInception":
        qe = bq.calibrate_e2e(sd, crops.cuda())
        walk = lambda q, h: bq._walk_trunk(bq._E2EOps(q), h)  # noqa: E731
    else:
        class Acts(iq._ForwardOps):     # the last concat, before the mean
            def finish(self, y):
                return y

        qe = iq.calibrate_e2e_iv3(sd, crops.cuda())
        walk = lambda q, h: iq._walk_trunk(Acts(q), h)  # noqa: E731
    qd = bq.tree_to(qe, "cuda")
    g = torch.Generator().manual_seed(hw)
    h1, h2 = (torch.randint(0, 128, (8, hw, hw, 192), generator=g,
                            dtype=torch.int8) for _ in range(2))
    with torch.no_grad():
        reset_launch_counts()
        eager1 = walk(qd, h1.cuda())
        eager2 = walk(qd, h2.cuda())
        torch.cuda.synchronize()
        assert concat_counts() == {"concat_in_place": 2 * concats,
                                   "concat_copied": 0}
        graph = CudaStepGraph("cuda")
        static_in = torch.empty_like(h1, device="cuda")
        with tally_launches() as tally:
            static_out = graph.capture(lambda: walk(qd, static_in))
        assert tally["concat_in_place"] == concats
        assert "concat_copied" not in tally
        replays = []
        for h in (h1, h2):
            static_in.copy_(h.cuda())
            graph.replay()
            add_launch_counts(tally)
            replays.append(static_out.clone())
        torch.cuda.synchronize()
        assert concat_counts()["concat_in_place"] == 4 * concats
        assert torch.equal(replays[0], eager1)
        assert torch.equal(replays[1], eager2)
        assert not torch.equal(eager1, eager2) and eager1.max() > 0
        plain = walk(qe, h1[:2])
    assert torch.equal(eager1[:2].cpu(), plain)
