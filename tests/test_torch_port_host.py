"""Port parity, host side: config, dataset plan, STPP pooling, device
transforms, shared-stem window geometry, synthetic frames and calibration
frames — each held against its action_detection_tpu twin on the same
numpy inputs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.config import get_configs as j_get_configs
from action_detection_tpu.data import pipeline as jpipe
from action_detection_tpu.data import transforms as jtf
from action_detection_tpu.data.ssn_dataset import SSNDataset as JSSNDataset
from action_detection_tpu.models.backbones import get_backbone as j_get_backbone
from action_detection_tpu.models.backbones import quantize as jquant
from action_detection_tpu.ops import stpp as jstpp

from action_detection_torch.config import get_configs
from action_detection_torch.data import pipeline as pipe
from action_detection_torch.data import transforms as tf
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.models.backbones import quantize as quant
from action_detection_torch.ops import stpp

from tests.test_datasets import write_proposal_list


@pytest.mark.parametrize("name", ["thumos14", "activitynet1.2"])
def test_config_matches_yaml(name):
    assert dataclasses.asdict(get_configs(name)) == \
        dataclasses.asdict(j_get_configs(name))
    assert np.array_equal(get_configs(name).iou_range,
                          j_get_configs(name).iou_range)


@pytest.mark.parametrize("new_length,interval", [(1, 6), (1, 40), (5, 7)])
def test_get_test_sample_matches(tmp_path, new_length, interval):
    pf = write_proposal_list(tmp_path / "p.txt", n_videos=3, seed=3)
    ours = SSNDataset(pf, get_configs("thumos14").sampling,
                      new_length=new_length, test_interval=interval)
    ref = JSSNDataset(pf, j_get_configs("thumos14").sampling,
                      new_length=new_length, test_interval=interval)
    assert len(ours.video_list) == len(ref.video_list) == 3
    np.testing.assert_array_equal(ours.stats, ref.stats)
    for i in range(3):
        a, b = ours.get_test_sample(i), ref.get_test_sample(i)
        assert a.video_id == b.video_id and a.num_frames == b.num_frames
        for f in ("frame_ticks", "rel_props", "prop_ticks", "prop_scaling"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _random_ticks(rng, P, T):
    t = np.sort(rng.randint(-3, T + 3, size=(P, 4)), axis=1)
    return t.astype(np.int64)


@pytest.mark.parametrize("cfg_raw,standalone,with_reg", [
    ((1, 1, 1), True, True),
    ((1, (1, 2), 1), True, True),
    ((1, (1, 2), 1), False, False),
])
def test_reorganized_stpp_pool_matches(cfg_raw, standalone, with_reg):
    rng = np.random.RandomState(0)
    K, T, P = 5, 37, 23
    cfg = stpp.StppConfig.from_raw(cfg_raw)
    jcfg = jstpp.StppConfig.from_raw(cfg_raw)
    J = cfg.feat_multiplier
    layout = stpp.ReorganizedScoreLayout(K + 1, K, 2 * K, J,
                                         standalone_classifier=standalone,
                                         with_regression=with_reg)
    jlayout = jstpp.ReorganizedScoreLayout(K + 1, K, 2 * K, J,
                                           standalone_classifier=standalone,
                                           with_regression=with_reg)
    assert layout.total_cols == jlayout.total_cols
    ticks = _random_ticks(rng, P, T - 5)
    scal = rng.rand(P, 2).astype(np.float32)
    scores = rng.randn(T, layout.total_cols).astype(np.float32)
    num_frames = T - 5

    pl, pr = stpp.reference_part_bounds(ticks, cfg)
    jpl, jpr = jstpp.reference_part_bounds(ticks, jcfg)
    np.testing.assert_array_equal(pl, jpl)
    np.testing.assert_array_equal(pr, jpr)

    got = stpp.reorganized_stpp_pool(torch.from_numpy(scores), ticks, scal,
                                     layout, cfg, num_frames=num_frames)
    ref = jstpp.reorganized_stpp_pool(jnp.asarray(scores), ticks,
                                      jnp.asarray(scal), jlayout, jcfg,
                                      num_frames=num_frames)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("modality,new_length,channels", [
    ("RGB", 1, 3), ("Flow", 5, 10)])
def test_device_transforms_match(modality, new_length, channels):
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 256, size=(3, 40, 52, channels), dtype=np.uint8)
    spec = get_backbone("TinyConv", modality, new_length)[2]
    jspec = j_get_backbone("TinyConv", modality, new_length)[2]
    xn, fs = tf.device_normed_pair(torch.from_numpy(frames), spec, modality,
                                   new_length)
    jxn, jfs = jtf.device_normed_pair(jnp.asarray(frames), jspec, modality,
                                      new_length)
    np.testing.assert_array_equal(xn.numpy(), np.asarray(jxn))
    np.testing.assert_array_equal(fs.numpy(), np.asarray(jfs))
    got = tf.device_oversample_normed(torch.from_numpy(frames), spec,
                                      modality, new_length)
    ref = jtf.device_oversample_normed(jnp.asarray(frames), jspec, modality,
                                       new_length)
    assert got.shape == (30, 32, 32, channels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sharedstem_crop_windows_identity_stem():
    """Identity stem + identity feature map: the windows are the snapped,
    mirrored pixel windows themselves — any geometry drift shows."""
    rng = np.random.RandomState(2)
    xn = rng.randn(2, 52, 75, 4).astype(np.float32)
    flip_src = rng.randn(2, 52, 75, 4).astype(np.float32)
    got = quant.sharedstem_crop_windows(lambda x: x, lambda s: s,
                                        torch.from_numpy(xn),
                                        torch.from_numpy(flip_src), 36)
    ref = jquant.sharedstem_crop_windows(lambda x: x, lambda s: s,
                                         jnp.asarray(xn),
                                         jnp.asarray(flip_src), 36)
    assert got.shape == (20, 36, 36, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
def test_synthetic_frames_byte_equal(modality):
    ours = pipe.SyntheticFrameProvider(modality=modality)
    ref = jpipe.SyntheticFrameProvider(modality=modality)
    for vid, idx in (("video_0", 1), ("video_test_0000004", 1234)):
        a = ours.load(vid, idx)
        b = [np.asarray(im) for im in ref.load(vid, idx)]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == np.uint8
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch,size", [("BNInception", (340, 256)),
                                       ("TinyConv", (80, 72))])
def test_calibration_frames_byte_equal(tmp_path, arch, size):
    """The 10-crop calibration frames: numpy slicing/flipping at the THUMOS
    scale size, and through the numpy rescale at TinyConv's."""
    pf = write_proposal_list(tmp_path / "p.txt", n_videos=3, seed=1)
    spec = get_backbone(arch, "RGB")[2]
    w, h = size
    got = pipe.collect_calibration_frames(
        SSNDataset(pf, test_interval=40),
        pipe.SyntheticFrameProvider(width=w, height=h),
        pipe.make_test_transform(spec.input_size, spec.scale_size, 10))
    ref = jpipe.collect_calibration_frames(
        JSSNDataset(pf, JSamplingConfig(), test_interval=40),
        jpipe.SyntheticFrameProvider(width=w, height=h),
        jpipe.make_test_transform(spec.input_size, spec.scale_size, 10))
    assert got.shape == (30, spec.input_size, spec.input_size, 3)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_scaled_frame_chunks_match():
    """Per-tick decode + rescale + padding of the device-crops pipeline."""
    ticks = np.arange(1, 60, 6)
    prov = pipe.SyntheticFrameProvider(width=80, height=72)
    jprov = jpipe.SyntheticFrameProvider(width=80, height=72)
    got = list(pipe.iter_scaled_frame_chunks(prov, "v", ticks, 60, 36,
                                             batch_ticks=4))
    ref = list(jpipe.iter_scaled_frame_chunks(jprov, "v", ticks, 60, 36,
                                              batch_ticks=4))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pipe.pad_chunk_ticks(a, 1, 4),
                                      jpipe.pad_chunk_ticks(b, 1, 4))


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
def test_directory_frames_decode_equal(tmp_path, modality):
    """JPEG frames decode to the same bytes as the JAX provider's images."""
    from PIL import Image

    rng = np.random.RandomState(3)
    d = tmp_path / "video_0"
    d.mkdir()
    Image.fromarray(rng.randint(0, 256, (24, 30, 3), dtype=np.uint8)) \
        .save(d / "img_00007.jpg")
    for axis in ("x", "y"):
        Image.fromarray(rng.randint(0, 256, (24, 30), dtype=np.uint8)) \
            .save(d / f"flow_{axis}_00007.jpg")
    tmpl = "img_{:05d}.jpg" if modality == "RGB" else "flow_{}_{:05d}.jpg"
    got = pipe.DirectoryFrameProvider(str(tmp_path), tmpl, modality) \
        .load("video_0", 7)
    ref = jpipe.DirectoryFrameProvider(str(tmp_path), tmpl, modality) \
        .load("video_0", 7)
    assert len(got) == len(ref) == (1 if modality == "RGB" else 2)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
