"""Port parity, float models: BNInception, TinyConv and the fused test FC
through the weight bridge, against the flax models at the tolerance of
tests/test_torch_parity.py (atol 1e-4, rtol 1e-3); plus the .pt checkpoint
round trip."""

from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models import fuse_test_heads as j_fuse
from action_detection_tpu.models import jitted_init
from action_detection_tpu.models.backbones import get_backbone as j_get_backbone

from action_detection_torch.models import (SSN, fuse_test_heads, seeded_init,
                                           state_dict_from_jax)
from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.train import load_checkpoint, save_checkpoint

from tests.test_torch_port_int8 import _jitter


def test_bninception_float_matches_flax():
    jbb, _, _ = j_get_backbone("BNInception", "RGB")
    variables = _jitter(jitted_init(jbb, jax.random.PRNGKey(1),
                                    jnp.zeros((1, 64, 64, 3))), seed=1)
    rng = np.random.RandomState(0)
    x = (rng.rand(2, 64, 64, 3) * 255.0 - 117.0).astype(np.float32)
    ref = np.asarray(jax.jit(jbb.apply)(variables, jnp.asarray(x)))

    bb, dim, spec = get_backbone("BNInception", "RGB")
    bb.load_state_dict(state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"])))
    with torch.no_grad():
        got = bb.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, dim)
    assert astuple(spec) == astuple(j_get_backbone("BNInception", "RGB")[2])
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("hw", [(32, 32), (33, 47)])
def test_tinyconv_matches_flax(hw):
    jbb, _, _ = j_get_backbone("TinyConv", "RGB")
    variables = _jitter(jbb.init(jax.random.PRNGKey(2),
                                 jnp.zeros((1, 32, 32, 3))), seed=2)
    rng = np.random.RandomState(1)
    x = (rng.rand(3, *hw, 3) * 255.0 - 117.0).astype(np.float32)
    ref = np.asarray(jbb.apply(variables, jnp.asarray(x)))
    bb, _, spec = get_backbone("TinyConv", "RGB")
    bb.load_state_dict(state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"])))
    with torch.no_grad():
        got = bb.eval()(torch.from_numpy(x)).numpy()
    assert astuple(spec) == astuple(j_get_backbone("TinyConv", "RGB")[2])
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("stpp_cfg,standalone,with_reg", [
    ((1, 1, 1), True, True),
    ((1, (1, 2), 1), True, False),
    ((1, (1, 2), 1), False, True),
])
def test_fuse_test_heads_and_scores_match(stpp_cfg, standalone, with_reg):
    """SSN heads through the bridge: the fused test FC, and per-frame fused
    scores against ``SSN.score_frames``."""
    K = 5
    jm = JSSN(num_class=K, base_model="TinyConv", dropout=0.0,
              stpp_cfg=stpp_cfg, with_regression=with_reg,
              standalone_classifier=standalone)
    v = jm.init({"params": jax.random.PRNGKey(3)},
                jnp.zeros((1, 9, 32, 32, 3)), jnp.ones((1, 2)), train=False)
    v = _jitter(v, seed=3)
    # non-trivial head biases (flax initializes them to zero)
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + rng.randn(*a.shape).astype(np.float32)
                      if p[-1].key == "bias" and p[0].key.endswith("_fc")
                      else a), jax.device_get(v["params"]))
    jk, jb = j_fuse(params, K, stpp_cfg, with_regression=with_reg,
                    standalone_classifier=standalone)

    model = SSN(num_class=K, base_model="TinyConv", dropout=0.0,
                stpp_cfg=stpp_cfg, with_regression=with_reg,
                standalone_classifier=standalone)
    model.load_state_dict(state_dict_from_jax(
        params, jax.device_get(v["batch_stats"])))
    kernel, bias = fuse_test_heads(model, K, stpp_cfg,
                                   with_regression=with_reg,
                                   standalone_classifier=standalone)
    np.testing.assert_array_equal(kernel.numpy(), np.asarray(jk))
    np.testing.assert_allclose(bias.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)

    x = (rng.rand(4, 32, 32, 3) * 255.0 - 117.0).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params,
                               "batch_stats": v["batch_stats"]},
                              jnp.asarray(x), jk, jb,
                              method=JSSN.score_frames))
    with torch.no_grad():
        got = (model.eval().features(torch.from_numpy(x)) @ kernel
               + bias).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_checkpoint_round_trip(tmp_path):
    model = seeded_init(SSN(num_class=20, base_model="TinyConv"), seed=5)
    rs = np.array([[0.1, -0.2], [0.3, 0.4]], np.float32)
    path = str(tmp_path / "ck.pt")
    save_checkpoint(path, model.state_dict(), rs, arch="TinyConv", epoch=3)
    ck = load_checkpoint(path)
    assert ck["arch"] == "TinyConv" and ck["epoch"] == 3
    np.testing.assert_array_equal(ck["reg_stats"], rs)
    other = SSN(num_class=20, base_model="TinyConv")
    other.load_state_dict(ck["state_dict"])
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                other.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def test_unported_backbone_names_the_later_slice():
    """Every backbone of the JAX registry is ported (ResNet and VGG since
    the checkpoint-interop slice): a name no registry knows raises
    ValueError, as the JAX registry's does."""
    for name in ("resnet50", "vgg16"):
        with torch.device("meta"):      # no weights are made
            assert get_backbone(name)[1] == j_get_backbone(name)[1]
    for name in ("resnet51", "vgg17"):
        with pytest.raises(ValueError, match="Unknown base model"):
            get_backbone(name)
