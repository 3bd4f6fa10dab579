"""The rate, window and interval arithmetic on made-up spans, and the
roofline and model-FLOP counts against counts worked out by hand."""

import importlib.util
import os

import pytest

from conftest import ROOT
from portbench.harness import layers, peaks
from portbench.harness import trace as tr
from portbench.harness.score import Call, ScoreRun


def _reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_union_busy_and_gaps():
    iv = [(10, 20, "a"), (15, 30, "b"), (40, 50, "c"), (45, 47, "d")]
    assert tr.union(iv) == [(10, 30), (40, 50)]
    assert tr.busy_ns(iv) == 30
    assert tr.busy_ns(iv, 12, 45) == 18 + 5
    assert tr.gaps(iv, 0, 60) == [(0, 10), (30, 40), (50, 60)]
    assert tr.time_by_name(iv, "c") == {"c": 10 / 1e9}


def test_breakdown_orders_and_labels():
    iv = [(0, 100, "k1"), (100, 150, "k2"), (300, 310, "k1"),
          (400, 1000, "copy")]
    out = tr.breakdown(iv, 0, 1000, {"provider.load": [(160, 290)],
                                     "score_videos": [(0, 1000)]})
    assert out["device_ops"][0] == ["copy", 600 / 1e9]
    assert out["device_ops"][1][0] == "k1"
    assert out["device_ops"][1][1] == pytest.approx(110 / 1e9)
    (first, s1), (second, s2) = out["idle_gaps"]
    assert (s1, s2) == pytest.approx((150 / 1e9, 90 / 1e9))
    assert "provider.load x1" in first and "score_videos x1" in first
    assert "provider.load" not in second


def _run(calls, config=None, intervals=None, scorers=None):
    return ScoreRun(config or {"chunk_ticks": 64}, calls,
                    scorers=scorers, intervals=intervals)


def test_rate_is_ticks_over_first_start_to_last_end():
    calls = [Call(["a"], 1000, 10.0, 12.0, 0, 2, {}),
             Call(["b"], 500, 12.5, 14.0, 0, 4, {})]
    run = _run(calls)
    assert run.ticks == 1500
    assert run.window_s == pytest.approx(4.0)
    assert run.ticks / run.window_s == pytest.approx(375.0)


ROWS = [
    # a 3x3 int8 conv: 4x4x8 -> 4x4x16 over an 8-channel input
    {"name": "c", "op": "conv", "precision": "int8", "per": "crop",
     "in": [4, 4, 8], "out": [4, 4, 16], "kernel": [3, 3], "stride": 1},
    # a bf16 1x1 stem conv
    {"name": "s", "op": "conv", "precision": "bf16", "per": "stem",
     "in": [8, 8, 3], "out": [8, 8, 4], "kernel": [1, 1], "stride": 1},
    {"name": "p", "op": "max_pool", "precision": "int8", "per": "crop",
     "in": [4, 4, 16], "out": [2, 2, 16], "kernel": [3, 3], "stride": 2},
    {"name": "heads", "op": "fc", "precision": "f32", "per": "tick",
     "in": [16], "out": [5]},
]
CFG = {"per_tick": {"stem": 2, "crop": 10, "tick": 1}, "score_layers": ROWS,
       "chunk_ticks": 64}


def test_counts_by_hand():
    conv, stem, pool, fc = ROWS
    assert peaks.macs(conv) == 4 * 4 * 16 * 9 * 8
    assert peaks.ops(conv) == 2 * 18432
    # x, w, out in int8, a float32 scale and bias an output channel
    assert peaks.nbytes(conv) == 128 + 16 * 9 * 8 + 256 + 16 * 8
    assert peaks.nbytes(stem) == 2 * (192 + 256) + 2 * 12 + 2 * 4
    assert peaks.ops(pool) == 2 * 2 * 16 * 9
    assert peaks.nbytes(fc) == 4 * (16 + 5) + 4 * 80 + 4 * 5
    assert peaks.row_bound_s(conv) == pytest.approx(
        max(1664 / 3.35e12, 36864 / 1979e12))
    want = (10 * 36864 / 1979e12 + 2 * 2 * 256 * 3 / 989e12
            + 160 / 67e12)
    assert layers.peak_seconds_per_tick(CFG) == pytest.approx(want)


class _Scorer:
    def __init__(self, device_ticks, real_ticks):
        self.device_ticks, self.real_ticks = device_ticks, real_ticks


def test_readers_by_hand():
    # two calls of 100 ticks over 2 s; 128 device ticks (2 chunks), the
    # window [0, 2e9] ns, K1 busy 1 ms, a 3 ms copy, 1 s busy in all
    calls = [Call(["a"], 60, 0.0, 1.0, 0, 10 ** 9, {}),
             Call(["b"], 40, 1.0, 2.0, 10 ** 9, 2 * 10 ** 9, {})]
    iv = [(0, 10 ** 6, "void int8_conv_kernel<1>(...)"),
          (10 ** 6, 4 * 10 ** 6, "Memcpy HtoD (Pageable -> Device)"),
          (5 * 10 ** 6, 10 ** 9, "other")]
    run = _run(calls, CFG, iv, [_Scorer(128, 100)])
    run.load_spans = [(0, 5 * 10 ** 6), (10, 20)]
    assert _reader("k1_roofline.score")(run) == pytest.approx(
        100 * 10 * peaks.row_bound_s(ROWS[0]) * 128 / 1e-3)
    assert _reader("mfu.score")(run) == pytest.approx(
        100 * 100 * layers.peak_seconds_per_tick(CFG) / 2.0)
    assert _reader("h2d_ms.score")(run) == pytest.approx(3.0 / 2)
    assert _reader("pad_share.score")(run) == pytest.approx(100 * 28 / 128)
    busy = (4 * 10 ** 6 + 10 ** 9 - 5 * 10 ** 6) / 1e9
    assert run.busy_s == pytest.approx(busy)
    assert _reader("device_idle.score")(run) == pytest.approx(
        100 * (1 - busy / 2))
    assert _reader("device_ms_per_chunk.score")(run) == pytest.approx(
        busy * 1e3 / 2)
    assert _reader("host_decode_ms.score")(run) == pytest.approx(
        (5e6 + 10) / 1e6 / 100)


def test_readers_find_nothing_without_a_trace():
    calls = [Call(["a"], 60, 0.0, 1.0, 0, 10 ** 9, {})]
    run = _run(calls, CFG, [], [_Scorer(64, 60)])
    for name in ("k1_roofline.score", "h2d_ms.score", "device_idle.score",
                 "device_ms_per_chunk.score", "host_decode_ms.score"):
        assert _reader(name)(run) is None
