"""Port parity, the training CLIs' host side: the TSN training augmentation
(``GroupMultiScaleCrop``, ``GroupRandomCrop``, ``GroupRandomSizedCrop``,
flips with the flow-x invert, ``get_train_augmentation``) on uint8 arrays
against the JAX package's PIL transforms on the same ``RandomState``: every
byte equal, and the RandomState left in the same state; the training
batches of ``assemble_train_batch`` and ``assemble_binary_batch`` byte-equal
to the JAX CLIs' for BNInception and TinyConv specs, RGB and Flow; and the
``PrefetchLoader``: order, backpressure, a worker's exception raised on the
consumer."""

import threading
import time

import numpy as np
import pytest
from PIL import Image

from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.data import pipeline as jpipe
from action_detection_tpu.data import transforms as jtr
from action_detection_tpu.data.binary_dataset import (
    BinaryDataset as JBinaryDataset)
from action_detection_tpu.data.ssn_dataset import SSNDataset as JSSNDataset

from action_detection_torch.config import SamplingConfig
from action_detection_torch.data import pipeline, transforms as tr
from action_detection_torch.data.binary_dataset import BinaryDataset
from action_detection_torch.data.ssn_dataset import SSNDataset

from tests.test_datasets import write_proposal_list


def _group(seed, h, w, modality, n=3):
    """A frame group: uint8 arrays and the same as PIL images (Flow: x, y
    planes alternating, mode L)."""
    rng = np.random.RandomState(seed)
    if modality == "RGB":
        arrs = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
                for _ in range(n)]
        return arrs, [Image.fromarray(a, "RGB") for a in arrs]
    arrs = [rng.randint(0, 256, (h, w), dtype=np.uint8) for _ in range(2 * n)]
    return arrs, [Image.fromarray(a, "L") for a in arrs]


def _check(jt, pt, seed, h, w, modality, n=3):
    """The port transform ``pt`` equals the JAX one ``jt`` on one group and
    leaves its RandomState where the JAX one leaves it."""
    arrs, pils = _group(seed, h, w, modality, n)
    jr, pr = np.random.RandomState(seed), np.random.RandomState(seed)
    want = [np.asarray(im) for im in jt(pils, jr)]
    got = pt(arrs, pr)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert jr.randint(1 << 30) == pr.randint(1 << 30)
    return got


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
@pytest.mark.parametrize("size,hw", [(224, (256, 340)), (32, (40, 48)),
                                     (299, (341, 452))])
def test_train_augmentation_bit_exact(modality, size, hw):
    """get_train_augmentation over 12 seeds a geometry: multi-scale crop at
    the 13 fixed offsets (upscale and downscale, aspect-distorted pairs),
    resize, random flip (Flow inverts its x planes)."""
    for seed in range(12):
        _check(jtr.get_train_augmentation(size, modality),
               tr.get_train_augmentation(size, modality), seed, *hw, modality,
               n=2)


@pytest.mark.parametrize("more_fix_crop", [True, False])
def test_multiscale_crop_offsets_and_fix_crop_modes(more_fix_crop):
    """The 13 (or 5) offsets each drawn, and the random-offset mode."""
    seen = set()
    for seed in range(40):
        arrs, _ = _group(seed, 64, 80, "RGB", n=1)
        jt = jtr.GroupMultiScaleCrop(48, more_fix_crop=more_fix_crop)
        pt = tr.GroupMultiScaleCrop(48, more_fix_crop=more_fix_crop)
        _check(jt, pt, seed, 64, 80, "RGB", n=1)
        seen.add(pt.sample_crop((80, 64), np.random.RandomState(seed))[2:])
        jt = jtr.GroupMultiScaleCrop(48, fix_crop=False)
        pt = tr.GroupMultiScaleCrop(48, fix_crop=False)
        _check(jt, pt, seed, 64, 80, "RGB", n=1)
    assert len(seen) > (8 if more_fix_crop else 3)


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
def test_random_crop_and_sized_crop_bit_exact(modality):
    """GroupRandomCrop (a crop smaller than the frame and one equal to it)
    and GroupRandomSizedCrop, its 10-try area/aspect loop and its fallback
    (scale + random crop) on frames too thin for any try."""
    for seed in range(10):
        _check(jtr.GroupRandomCrop(24), tr.GroupRandomCrop(24), seed, 40, 48,
               modality)
        _check(jtr.GroupRandomCrop((40, 48)), tr.GroupRandomCrop((40, 48)),
               seed, 40, 48, modality)
        _check(jtr.GroupRandomSizedCrop(32), tr.GroupRandomSizedCrop(32),
               seed, 60, 90, modality)
        got = _check(jtr.GroupRandomSizedCrop(12),
                     tr.GroupRandomSizedCrop(12), seed, 16, 300, modality)
        assert got[0].shape[:2] == (12, 12)


def test_flow_flip_inverts_x_planes():
    arrs, pils = _group(3, 8, 10, "Flow", n=2)
    flip = tr.GroupRandomHorizontalFlip(is_flow=True)
    rng = np.random.RandomState(0)
    while True:        # find a seed state that flips
        state = rng.get_state()
        if rng.rand() < 0.5:
            break
    rng.set_state(state)
    got = flip(arrs, rng)
    np.testing.assert_array_equal(got[0], 255 - arrs[0][:, ::-1])
    np.testing.assert_array_equal(got[1], arrs[1][:, ::-1])


def _pair_batches(tmp_path, modality, size, hw, videos, binary=False,
                  segs=(1, 1)):
    """The same training batch from the JAX package and from the port, with
    get_train_augmentation at ``size`` on synthetic ``hw`` frames."""
    prop = write_proposal_list(tmp_path / "p.txt")
    L = 1 if modality == "RGB" else 5
    body, aug = segs
    if binary:
        jds = JBinaryDataset(prop, body_seg=body, new_length=L)
        ds = BinaryDataset(prop, body_seg=body, new_length=L)
    else:
        jds = JSSNDataset(prop, JSamplingConfig(), body_seg=body,
                          aug_seg=aug, new_length=L)
        ds = SSNDataset(prop, SamplingConfig(), body_seg=body, aug_seg=aug,
                        new_length=L)
    h, w = hw
    jprov = jpipe.SyntheticFrameProvider(w, h, modality=modality)
    prov = pipeline.SyntheticFrameProvider(w, h, modality=modality)
    jaug = jtr.get_train_augmentation(size, modality)
    aug_t = tr.get_train_augmentation(size, modality)
    if binary:
        # the JAX binary_train's assemble(), inlined
        rng = np.random.RandomState(11)
        frames, labels = [], []
        for vi in videos:
            s = jds.get_training_sample(vi, rng)
            for i in range(s.frame_indices.shape[0]):
                vid = s.frame_video_ids[i]
                pil = jpipe.load_proposal_frames(
                    jprov, vid, s.frame_indices[i],
                    jds.video_dict[vid].num_frames, L)
                st = jtr.Stack()(jaug(pil, rng))
                H, W, C = st.shape
                frames.append(st.reshape(H, W, body, C // body)
                              .transpose(2, 0, 1, 3))
            labels.append(s.labels)
        jb = {"frames": np.stack(frames).astype(np.uint8),
              "labels": np.concatenate(labels)}
        tb = pipeline.assemble_binary_batch(ds, list(videos), prov, aug_t,
                                            np.random.RandomState(11))
    else:
        jb = jpipe.assemble_train_batch(jds, list(videos), jprov, jaug,
                                        np.random.RandomState(11))
        tb = pipeline.assemble_train_batch(ds, list(videos), prov, aug_t,
                                           np.random.RandomState(11))
    return jb, tb


@pytest.mark.parametrize("modality,size,hw,videos,binary,segs", [
    ("RGB", 224, (256, 340), (0,), False, (1, 1)),     # BNInception spec
    ("RGB", 32, (40, 48), (0, 1, 2), False, (5, 2)),   # TinyConv, recipe segs
    ("Flow", 224, (256, 340), (1,), False, (1, 1)),
    ("Flow", 32, (40, 48), (0, 2), False, (2, 1)),
    ("RGB", 32, (40, 48), (0, 1), True, (5, 2)),       # binary_train batch
    ("Flow", 32, (40, 48), (2,), True, (3, 2)),
])
def test_training_batches_byte_equal(tmp_path, modality, size, hw, videos,
                                     binary, segs):
    jb, tb = _pair_batches(tmp_path, modality, size, hw, videos, binary,
                           segs)
    assert set(jb) == set(tb)
    c = 3 if modality == "RGB" else 10
    S = segs[0] if binary else segs[0] + 2 * segs[1]
    P = 12 if binary else 8
    assert tb["frames"].shape == (P * len(videos), S, size, size, c)
    for key in jb:
        assert tb[key].dtype == jb[key].dtype, key
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)


def test_prefetch_loader_order_and_backpressure():
    """Batches come out in index order although workers finish out of
    order; with a slow consumer at most prefetch + threads + 3 batches are
    made and not yet consumed: the queue's, the one the producer holds
    while it blocks, the submitted ones (threads + 1) and the consumer's
    own."""
    made, lock = [], threading.Lock()
    consumed = [0]

    def make(i):
        time.sleep(0.002 * ((7 * i) % 5))
        with lock:
            made.append(i)
            assert len(made) - consumed[0] <= 2 + 3 + 3
        return {"i": i}

    loader = pipeline.PrefetchLoader(make, 24, prefetch=2, num_threads=3)
    got = []
    for b in loader:
        time.sleep(0.004)
        got.append(b["i"])
        with lock:
            consumed[0] += 1
    assert got == list(range(24))
    assert len(loader.batch_seconds) == 24
    assert all(s > 0 for s in loader.batch_seconds)


def test_prefetch_loader_raises_worker_error_on_consumer():
    def make(i):
        if i == 5:
            raise FileNotFoundError("frame img_00042.jpg")
        return {"i": i}

    out, err = [], []

    def consume():
        try:
            for b in pipeline.PrefetchLoader(make, 12, num_threads=2):
                out.append(b["i"])
        except FileNotFoundError as e:
            err.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "the consumer hung"
    assert out == [0, 1, 2, 3, 4]
    assert err and "img_00042" in str(err[0])
