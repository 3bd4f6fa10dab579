"""The scorers' staging ring (``infer/features.py:StagingRing``), on the
CPU.

A seeded TinyConv SSN scores three videos of 15 ticks (interval 40) in
chunks of 4, two of them at one scale shape and the middle one at
another, so packing fills 8 chunks of one shape and 4 of the other,
interleaved, each shape ending in a partial chunk, and every ring of 2
slots turns over several times. Packed scores equal per-video ones bit
for bit; every chunk sent, packed or per video, holds exactly the bytes
``np.stack`` (``iter_scaled_frame_chunks`` per video) and
``pad_chunk_ticks`` give, so a slot reused for a partial chunk after a
full one sends zeros in its tail rows; the counters count the chunks and
the slots, for the actionness scorer too. With fake copy events, no slot
is handed out to be written before the event of its last copy has been
waited on. The row gather that every device-crop chunk is built with
(``utils/native.py:gather_rows``, C++) equals its plain version and
refuses rows it cannot take. The benchmark's
``staging_reuse_share.score`` reads those counters. No JAX is
imported."""

import importlib.util
import json
import os
from dataclasses import astuple

import numpy as np
import pytest
import torch

from action_detection_torch.config import SamplingConfig
from action_detection_torch.data.binary_dataset import BinaryTestSample
from action_detection_torch.data.pipeline import (SyntheticFrameProvider,
                                                  iter_scaled_frame_chunks,
                                                  load_scaled_stack,
                                                  pad_chunk_ticks)
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.infer import features as features_mod
from action_detection_torch.infer.actionness import ActionnessScorer
from action_detection_torch.infer.features import StagingRing
from action_detection_torch.infer.scorer import ProposalScorer
from action_detection_torch.kernels import launch_counts, reset_launch_counts
from action_detection_torch.models import (SSN, BinaryClassifier,
                                           seeded_init)
from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.utils.native import gather_rows, gather_rows_plain

from tests.test_torch_port_spans import write_list

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3
CHUNK = 4
TALL = "video_1"


class TwoShapes:
    """Synthetic frames, 48x40 but for :data:`TALL`'s, at 40x48: two scale
    shapes."""

    modality = "RGB"

    def __init__(self):
        self.wide = SyntheticFrameProvider(width=48, height=40)
        self.tall = SyntheticFrameProvider(width=40, height=48)

    def load(self, vid, idx):
        return (self.tall if vid == TALL else self.wide).load(vid, idx)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    pf = write_list(tmp_path_factory.mktemp("staging") / "p.txt")
    ds = SSNDataset(pf, SamplingConfig(), test_interval=40)
    model = seeded_init(SSN(num_class=K, base_model="TinyConv",
                            dropout=0.0), seed=5)
    spec = get_backbone("TinyConv")[2]
    reg = np.array([[0.01, -0.02], [0.1, 0.2]], np.float32)

    def make():
        return ProposalScorer(model, spec, reg_stats=reg, num_class=K,
                              chunk_frames=CHUNK, device="cpu",
                              decode_threads=1)

    binary = seeded_init(BinaryClassifier(base_model="TinyConv",
                                          dropout=0.0), seed=5)

    def make_actionness():
        return ActionnessScorer(binary, spec, chunk_frames=CHUNK,
                                device="cpu", decode_threads=1)

    samples = [ds.get_test_sample(i) for i in range(len(ds.video_list))]
    return dict(ds=ds, make=make, make_actionness=make_actionness,
                samples=samples, spec=spec, provider=TwoShapes())


class Spy:
    """Wraps a ring's copy: keeps a copy of every chunk sent, and hands out
    fake events that note when they are waited on."""

    class Event:
        def __init__(self):
            self.waited = False

        def synchronize(self):
            self.waited = True

    def __init__(self, ring: StagingRing):
        self.sent = []             # (host pointer, bytes sent)
        self.events = {}           # host pointer -> events, in order
        copy = ring._copy

        def fake_copy(host):
            frames, event = copy(host)
            assert event is None                      # the CPU's copy
            event = Spy.Event()
            self.sent.append((host.data_ptr(), host.numpy().copy()))
            self.events.setdefault(host.data_ptr(), []).append(event)
            return frames, event

        ring._copy = fake_copy


def _expected_chunks(setup, pack=True):
    """The chunks packing sends, built as ``np.stack`` and
    ``pad_chunk_ticks`` build them: each scale shape's ticks in job order,
    in chunks of :data:`CHUNK`, flushed as they fill, the partial ones
    last. Per video, each video's ``iter_scaled_frame_chunks``, padded."""
    scale = setup["spec"].scale_size
    if not pack:
        return [pad_chunk_ticks(c, 1, CHUNK) for s in setup["samples"]
                for c in iter_scaled_frame_chunks(
                    setup["provider"], s.video_id, s.frame_ticks,
                    s.num_frames, scale, batch_ticks=CHUNK)]
    buffers, chunks = {}, []
    for s in setup["samples"]:
        for tick in s.frame_ticks:
            a = load_scaled_stack(setup["provider"], s.video_id, tick,
                                  s.num_frames, scale)
            buf = buffers.setdefault(a.shape, [])
            buf.append(a)
            if len(buf) == CHUNK:
                chunks.append(np.stack(buf))
                buffers[a.shape] = []
    chunks += [pad_chunk_ticks(np.stack(b), 1, CHUNK)
               for b in buffers.values() if b]
    return chunks


def test_pack_through_the_ring_equals_per_video(setup):
    with setup["make"]() as a:
        singles = [a.score_video(s, setup["provider"], keep_raw=True)
                   for s in setup["samples"]]
    with setup["make"]() as b:
        packed = b.score_video_pack(setup["samples"], setup["provider"],
                                    keep_raw=True)
    for p, s in zip(packed, singles):
        for g, r in zip(astuple(p)[1:], astuple(s)[1:]):
            np.testing.assert_array_equal(g, r)
    # per video 3 x 4 chunks; packed 8 of one shape and 4 of the other
    assert (a.staging.staged, b.staging.staged) == (12, 12)
    # two shapes either way, 2 slots each
    assert (a.staging.allocated, b.staging.allocated) == (4, 4)


@pytest.mark.parametrize("pack", [True, False])
def test_every_chunk_sent_is_the_stacked_padded_chunk(setup, pack):
    """Packed, and per video (each chunk sent once, through the ring)."""
    scorer = setup["make"]()
    spy = Spy(scorer.staging)
    if pack:
        scorer.score_video_pack(setup["samples"], setup["provider"])
    else:
        for s in setup["samples"]:
            scorer.score_video(s, setup["provider"])
    want = _expected_chunks(setup, pack)
    assert len(spy.sent) == len(want) == scorer.staging.staged == 12
    for (_, got), ref in zip(spy.sent, want):
        np.testing.assert_array_equal(got, ref)
    # the two shapes took turns (packed: interleaved; per video: the
    # middle video's), and each ring of 2 turned over
    shapes = [got.shape for _, got in spy.sent]
    assert len(set(shapes)) == 2
    assert sum(a != b for a, b in zip(shapes, shapes[1:])) >= (3 if pack
                                                               else 2)
    assert all(len(e) >= 2 for e in spy.events.values())
    assert len(spy.events) == 4
    scorer.close()


def test_a_partial_chunk_after_a_full_one_sends_zero_tail_rows(setup):
    scorer = setup["make"]()
    spy = Spy(scorer.staging)
    scorer.score_video_pack(setup["samples"], setup["provider"])
    last_full = {}
    partial = 0
    for ptr, got in spy.sent:
        real = np.flatnonzero(got.reshape(CHUNK, -1).any(axis=1))
        if len(real) < CHUNK:
            partial += 1
            # the slot held a full chunk before; its tail is zeros now
            assert last_full[ptr].reshape(CHUNK, -1).any(axis=1).all()
            assert list(real) == list(range(len(real)))
            assert not got[len(real):].any()
        else:
            last_full[ptr] = got
    assert partial == 2                 # one a shape
    scorer.close()


@pytest.mark.parametrize("kind", ["proposal", "actionness"])
def test_counters_and_release(setup, kind):
    """A call's counts (a packed proposal call; the actionness scorer's
    per-video calls, 4 chunks each); ``release`` gives the slots back and
    keeps the counts; the next chunk of a shape makes its slots anew."""
    if kind == "proposal":
        scorer = setup["make"]()
    else:
        scorer = setup["make_actionness"]()
    ring = scorer.staging
    assert (ring.staged, ring.allocated) == (0, 0)
    if kind == "proposal":
        scorer.score_video_pack(setup["samples"], setup["provider"])
    else:
        for s in setup["samples"]:
            out = scorer.score_video(
                BinaryTestSample(s.video_id, s.frame_ticks, s.num_frames),
                setup["provider"])
            assert out.shape == (15, 10, 2)
    assert (ring.staged, ring.allocated) == (12, 4)
    scorer.close()
    assert (ring.staged, ring.allocated) == (12, 4)
    assert not ring._rings
    slot = ring.take((CHUNK, 2, 2, 3), np.uint8)
    ring.send(slot)
    assert (ring.staged, ring.allocated) == (13, 6)


def test_slots_go_in_turn_and_out_of_turn_is_refused():
    ring = StagingRing(torch.device("cpu"))
    a = ring.take((2, 3), np.uint8)
    assert ring.take((2, 3), np.uint8) is a      # not sent yet: the same
    a.array[:] = 7
    out = ring.send(a)
    a.array[:] = 9                                  # a CPU copy is a clone
    assert (out.numpy() == 7).all()
    b = ring.take((2, 3), np.uint8)
    assert b is not a and ring.take((2, 3), np.uint8) is b
    ring.send(b)
    assert ring.take((2, 3), np.uint8) is a
    with pytest.raises(ValueError):
        ring.send(b)
    f = ring.take((2, 3), np.float32)
    assert f.host.dtype == torch.float32 and f is not a


@pytest.mark.parametrize("slots", [2, 3])
def test_no_slot_is_written_before_its_last_copy_is_waited_on(
        setup, monkeypatch, slots):
    """Fake events stand for the copies: every slot handed out by ``take``
    (the only way a chunk reaches a slot) has had the event of its last
    copy waited on, over a packed call and per-video calls, with two and
    three slots a shape."""
    monkeypatch.setattr(features_mod, "STAGING_SLOTS", slots)
    scorer = setup["make"]()
    spy = Spy(scorer.staging)
    take = scorer.staging.take
    handed = []

    def checked_take(shape, dtype):
        slot = take(shape, dtype)
        last = spy.events.get(slot.host.data_ptr())
        assert not last or last[-1].waited, "a slot in flight handed out"
        handed.append(slot.host.data_ptr())
        return slot

    scorer.staging.take = checked_take
    scorer.score_video_pack(setup["samples"], setup["provider"])
    for s in setup["samples"]:
        scorer.score_video(s, setup["provider"])
    assert len(handed) == 24
    assert scorer.staging.allocated == 2 * slots          # two shapes
    # every copy but each slot's last was waited on before its slot came
    # back; release waits on the rest
    scorer.close()
    assert all(e.waited for events in spy.events.values() for e in events)


@pytest.mark.parametrize("shape,dtype", [((5, 40, 48, 3), np.uint8),
                                         ((3, 7, 10), np.uint8),
                                         ((4, 6), np.float32)])
def test_gather_rows_equals_its_plain_version(shape, dtype):
    rng = np.random.RandomState(len(shape))
    rows = [(rng.rand(*shape[1:]) * 255).astype(dtype) for _ in range(9)]
    rows[2] = rows[2][::1]                       # a view
    for n in (shape[0], shape[0] - 2, 1, 0):
        got = np.full(shape, 7, dtype)
        want = got.copy()
        gather_rows(got, rows[:n])
        gather_rows_plain(want, rows[:n])
        np.testing.assert_array_equal(got, want)
    # a non-contiguous row is copied as its values
    got = np.zeros((2, 4, 6), np.uint8)
    src = np.arange(96, dtype=np.uint8).reshape(8, 12)[::2, ::2]
    gather_rows(got, [src, src.T.copy().T])
    np.testing.assert_array_equal(got, [src, src])


def test_gather_rows_refuses_what_it_cannot_take():
    out = np.zeros((2, 3, 4), np.uint8)
    with pytest.raises(ValueError):
        gather_rows(out, [np.zeros((3, 4), np.uint8)] * 3)
    with pytest.raises(ValueError):
        gather_rows(out, [np.zeros((4, 3), np.uint8)])
    with pytest.raises(ValueError):
        gather_rows(out, [np.zeros((3, 4), np.int16)])
    with pytest.raises(ValueError):
        gather_rows(np.zeros((3, 2, 4), np.uint8).transpose(1, 0, 2),
                    [np.zeros((3, 4), np.uint8)])
    ro = np.zeros((2, 3, 4), np.uint8)
    ro.setflags(write=False)
    with pytest.raises(ValueError):
        gather_rows(ro, [np.zeros((3, 4), np.uint8)])
    assert not out.any()


def test_packing_gathers_each_chunk_once(setup):
    """One native gather a chunk, packed or per video (4 chunks)."""
    reset_launch_counts()
    with setup["make"]() as scorer:
        scorer.score_video_pack(setup["samples"], setup["provider"])
        assert launch_counts()["host_gather_rows"] == 12
        scorer.score_video(setup["samples"][0], setup["provider"])
    assert launch_counts()["host_gather_rows"] == 12 + 4


def _reader():
    path = os.path.join(ROOT, "portbench", "metrics",
                        "staging_reuse_share.score.py")
    spec = importlib.util.spec_from_file_location("staging_reuse_share",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class _Run:
    def __init__(self, scorers):
        self.scorers = scorers


class _OldScorer:
    device_ticks, real_ticks = 64, 60


def test_staging_reuse_share_reader(setup):
    read = _reader()
    assert read(_Run([])) is None
    assert read(_Run(None)) is None
    # scorers without the counters (the program before the ring)
    assert read(_Run([_OldScorer(), _OldScorer()])) is None
    scorers = [setup["make"](), setup["make"]()]
    assert read(_Run(scorers)) is None               # nothing staged yet
    scorers[0].score_video_pack(setup["samples"], setup["provider"])
    scorers[1].score_video(setup["samples"][0], setup["provider"])
    for s in scorers:
        s.close()
    # 12 + 4 chunks staged through 4 + 2 slots
    assert read(_Run(scorers)) == pytest.approx(100.0 * (1 - 6 / 16))
    assert read(_Run(scorers + [_OldScorer()])) is None


def test_staging_reuse_share_entry():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "staging_reuse_share.score"]
    assert entry == {"name": "staging_reuse_share.score", "unit": "%",
                     "better": "higher", "source": "program_counter",
                     "layer": "H2D copy", "moves": "score_ticks_per_s",
                     "workloads": ["bni_thumos14.score_decoded"]}
    # the metrics appended after it
    names = [m["name"] for m in bench["per_layer"]]
    assert names[names.index(entry["name"]) + 1:] == [
        "graph_replay_share.score", "inplace_concat_share.score"]
    layers = {m["name"]: m["layer"] for m in bench["per_layer"]}
    assert layers["h2d_ms.score"] == entry["layer"]
