"""The port's C++ host kernels (``utils/native.py``, built with g++ from
``csrc/adt_native.cpp``): NMS and the TAG box search exactly equal to the
port's numpy plain versions and to the JAX package's library, ties and
degenerate spans included (mirrors ``tests/test_native.py``); the build
itself, and its failure as an ImportError that names the log."""

import os

import numpy as np
import pytest

from action_detection_tpu.utils import native as jax_native

from action_detection_torch.kernels import launch_counts, reset_launch_counts
from action_detection_torch.ops.nms import (temporal_nms_indices,
                                            temporal_nms_indices_plain)
from action_detection_torch.ops.tag import tag_box_search_plain
from action_detection_torch.utils import native


def _nms_all(starts, ends, scores, thresh, offset):
    got = native.nms_indices(starts, ends, scores, thresh, offset)
    np.testing.assert_array_equal(
        got, temporal_nms_indices_plain(starts, ends, scores, thresh, offset))
    np.testing.assert_array_equal(
        got, jax_native.nms_indices(starts, ends, scores, thresh, offset))
    return got


@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("thresh", [0.2, 0.4, 0.9])
def test_nms_matches_plain_and_jax(offset, thresh):
    rng = np.random.RandomState(int(thresh * 10) + int(offset))
    for _ in range(25):
        n = rng.randint(1, 80)
        starts = rng.rand(n) * 100
        ends = starts + rng.rand(n) * 30 + 0.1
        _nms_all(starts, ends, rng.rand(n), thresh, offset)
        # integer frame spans with many tied scores
        starts = rng.randint(0, 200, size=n).astype(np.float64)
        ends = starts + rng.randint(0, 40, size=n)
        _nms_all(starts, ends, rng.randint(0, 4, size=n) / 4.0, thresh,
                 offset)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_nms_ties_and_degenerate_spans(offset):
    """Tied scores visit the larger index first; a NaN IoU (zero-length
    boxes at offset 0) suppresses; a NaN score sorts first."""
    starts = np.array([5.0, 5.0, 5.0, 20.0, 20.0, 40.0, 60.0])
    ends = np.array([10.0, 10.0, 10.0, 20.0, 20.0, 50.0, 70.0])
    scores = np.array([0.5, 0.5, 0.5, 0.9, 0.9, 0.1, np.nan])
    _nms_all(starts, ends, scores, 0.4, offset)
    _nms_all(starts, ends, np.zeros(7), 0.0, offset)
    one = np.array([3.0])
    _nms_all(one, one, one, 0.5, offset)
    assert len(temporal_nms_indices([], [], [], 0.5, offset)) == 0


def _search_all(labels, scores, tol):
    labels = np.asarray(labels).astype(np.int64)
    length = len(labels)
    diff = np.zeros(length + 1, dtype=np.int64)
    diff[1:-1] = labels[1:] - labels[:-1]
    diff[0], diff[length] = labels[0], -labels[-1]
    up, down = np.nonzero(diff == 1)[0], np.nonzero(diff == -1)[0]
    got = native.tag_box_search(labels, scores, up, down, tol)
    np.testing.assert_array_equal(
        got, tag_box_search_plain(labels, scores, up, down, tol))
    np.testing.assert_array_equal(
        got, jax_native.tag_box_search(labels, scores, up, down, tol))
    assert got.shape == (2 * len(up) * len(tol), 3)
    return got


@pytest.mark.parametrize("density", [0.2, 0.4, 0.8])
def test_tag_search_matches_plain_and_jax(density):
    rng = np.random.RandomState(int(density * 10))
    tol = np.array([0.0, 0.05, 0.1, 0.3, 0.7, 1.0])
    for _ in range(15):
        length = rng.randint(2, 150)
        labels = rng.rand(length) < density
        labels[rng.randint(length)] = True
        _search_all(labels, rng.randn(length), tol)


def test_tag_search_degenerate_spans():
    """Runs touching both ends, a one-frame video, all foreground, single
    frames, and the backward fallback's extra frame."""
    tol = np.array([0.0, 0.5])
    for labels in ([1], [1, 1, 1], [1, 0, 1], [0, 1, 0], [1, 0, 0, 0, 1],
                   [0, 0, 1, 1, 0, 1, 0, 0, 1]):
        _search_all(labels, np.arange(len(labels), dtype=np.float64) - 2,
                    tol)


def test_launch_counts():
    reset_launch_counts()
    native.nms_indices(np.array([0.0]), np.array([1.0]), np.array([1.0]),
                       0.5)
    native.tag_box_search([1, 0], [1.0, 2.0], [0], [1], [0.1])
    counts = launch_counts()
    assert counts["host_nms"] == 1 and counts["host_tag_search"] == 1
    reset_launch_counts()
    assert launch_counts()["host_nms"] == 0


def test_builds_with_gxx(tmp_path):
    """A fresh build directory gets the library and its compiler log; a
    second call reuses it."""
    path = native.build_native(str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.isfile(path) and os.path.isfile(path + ".log")
    mtime = os.path.getmtime(path)
    assert native.build_native(str(tmp_path)) == path
    assert os.path.getmtime(path) == mtime


@pytest.mark.parametrize("cxx", ["false", "no-such-compiler-xyz"])
def test_broken_compiler_raises_importerror_naming_the_log(tmp_path,
                                                           monkeypatch, cxx):
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(ImportError, match=r"did not build \(log .*\.log\)"):
        native.build_native(str(tmp_path))
    logs = [f for f in os.listdir(tmp_path) if f.endswith(".log")]
    assert len(logs) == 1
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path))
    with open(tmp_path / logs[0]) as f:
        assert cxx in f.read()
