"""Port parity, training: the max-pool backward A1 (plain version on the
CPU) against the JAX package's Pallas kernel ``max_pool_bwd_pallas``
(interpret mode) and SelectAndScatter, bit-exact; the losses, the training
STPP, the training batch and the optimizer; and two whole SSN train steps
of a BNInception at 64^2 against the JAX trainer on the same batch.

The CUDA kernel itself has no CPU mode: its cases are in
tests/test_torch_port_kernels_cuda.py (``cuda`` marker), and
``python3 chip_smoke.py`` holds it against the plain version at the
training step's full shapes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.data import pipeline as jpipe
from action_detection_tpu.data import transforms as jtr
from action_detection_tpu.data.ssn_dataset import SSNDataset as JSSNDataset
from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models import jitted_init
from action_detection_tpu.models.backbones import get_backbone as j_get_backbone
from action_detection_tpu.ops import losses as jl
from action_detection_tpu.ops import pooling as jpool
from action_detection_tpu.ops.pool_bwd_pallas import max_pool_bwd_pallas
from action_detection_tpu.ops.stpp import StppConfig as JStppConfig
from action_detection_tpu.ops.stpp import stpp_train_pool as j_stpp_train_pool
from action_detection_tpu.train import LossWeights as JLossWeights
from action_detection_tpu.train import TrainState
from action_detection_tpu.train import make_optimizer as j_make_optimizer
from action_detection_tpu.train import make_train_step as j_make_train_step

from action_detection_torch.config import SamplingConfig
from action_detection_torch.data import pipeline, transforms
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.kernels.pool_bwd import max_pool_bwd
from action_detection_torch.models import SSN, state_dict_from_jax
from action_detection_torch.ops import losses
from action_detection_torch.ops.pooling import max_pool_2d
from action_detection_torch.ops.stpp import StppConfig, stpp_train_pool
from action_detection_torch.train import (LossWeights, batch_to_device,
                                          make_optimizer, make_train_step)
from action_detection_torch.train.optim import label_params

from tests.test_datasets import write_proposal_list
from tests.test_torch_port_int8 import (  # noqa: F401 (fixture)
    _jitter, one_torch_thread)

POOL_CASES = [  # kernel, stride, padding, H, W
    (3, 2, ((0, 1), (0, 1)), 15, 15),     # BNInception stem pool (ceil)
    (3, 2, ((0, 1), (0, 1)), 14, 14),     # even size, ceil pad
    (3, 2, ((0, 2), (0, 1)), 11, 17),     # asymmetric odd shape
    (3, 2, ((1, 1), (1, 1)), 12, 12),     # ResNet-style symmetric pad
    (2, 3, ((0, 0), (0, 0)), 13, 13),     # stride > kernel (gap cells)
    (3, 1, ((1, 1), (1, 1)), 9, 9),       # the 5b stride-1 branch pool
]


def _pool_input(H, W, kind, seed):
    rng = np.random.RandomState(seed)
    shape = (2, H, W, 5)
    if kind == "distinct":
        v = rng.permutation(int(np.prod(shape))).astype(np.float32)
        return (v / v.size - 0.5).reshape(shape), np.float32
    if kind == "tied":      # 4 levels: many equal maxima inside a window
        return rng.randint(0, 4, size=shape).astype(np.float32), np.float32
    return (rng.randint(0, 64, size=shape) / 8.0).astype(np.float32), \
        jnp.bfloat16        # bf16 with ties


@pytest.mark.parametrize("kind", ["distinct", "tied", "bf16"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_backward_bit_exact(case, kind):
    """A1's plain version equals SelectAndScatter (jax.grad of the max
    pool) and, for strided pools, the Pallas kernel — first-match routing,
    float32 sums rounded once."""
    kernel, stride, pad, H, W = case
    x_np, jdt = _pool_input(H, W, kind, seed=H * W + stride)
    x = jnp.asarray(x_np, jdt)
    k2, s2 = (kernel, kernel), (stride, stride)
    y = fnn.max_pool(x, k2, strides=s2, padding=list(pad))
    dy = ((jnp.arange(y.size) % 7 + 1).reshape(y.shape)).astype(jdt)
    _, vjp = jax.vjp(lambda v: fnn.max_pool(v, k2, strides=s2,
                                            padding=list(pad)), x)
    ref = np.asarray(vjp(dy)[0].astype(jnp.float32))

    tdt = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)

    got = max_pool_bwd(t(x), t(y), t(dy), k2, s2, pad)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), ref)
    if stride > 1:
        pal = max_pool_bwd_pallas(x, y, dy, k2, s2, pad)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(pal.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_pool_2d_forward_and_grad(dtype):
    """ops.pooling.max_pool_2d (forward + A1 backward through autograd) vs
    the JAX package's max_pool_2d in its Pallas mode."""
    rng = np.random.RandomState(3)
    x_np = (rng.randint(0, 32, size=(2, 13, 13, 6)) / 4.0).astype(np.float32)
    w_np = (np.arange(2 * 6 * 6 * 6) % 5 + 1).reshape(2, 6, 6, 6)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pad = ((0, 1), (0, 1))
    prev = jpool.set_pool_backward("pallas")
    try:
        def f(x):
            y = jpool.max_pool_2d(x, 3, 2, pad)
            return (y.astype(jnp.float32) * w_np).sum(), y
        (_, jy), jg = jax.value_and_grad(f, has_aux=True)(
            jnp.asarray(x_np, jdt))
    finally:
        jpool.set_pool_backward(prev)

    x = torch.from_numpy(x_np).to(dtype).requires_grad_()
    y = max_pool_2d(x, 3, 2, pad)
    (y.float() * torch.from_numpy(w_np).float()).sum().backward()
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(jg.astype(jnp.float32)))


def test_losses_match_jax():
    """Values and gradients of the three SSN losses and the accuracy, rtol
    1e-5 (float32 reductions in different orders)."""
    rng = np.random.RandomState(0)
    K, groups, split, gsize = 5, 4, 1, 7
    pred = rng.randn(groups * gsize, K).astype(np.float32)
    labels = rng.randint(1, K + 1, size=groups * gsize)
    logits = rng.randn(16, K + 1).astype(np.float32)
    act_labels = rng.randint(0, K + 1, size=16)
    reg = (rng.randn(6, K, 2) * 2).astype(np.float32)
    reg_labels = rng.randint(1, K + 1, size=6)
    targets = rng.randn(6, 2).astype(np.float32)

    cases = [
        (lambda p: jl.completeness_loss(p, jnp.asarray(labels), split, gsize),
         lambda p: losses.completeness_loss(p, torch.from_numpy(labels),
                                            split, gsize), pred),
        (lambda p: jl.activity_cross_entropy(p, jnp.asarray(act_labels)),
         lambda p: losses.activity_cross_entropy(
             p, torch.from_numpy(act_labels)), logits),
        (lambda p: jl.classwise_regression_loss(p, jnp.asarray(reg_labels),
                                                jnp.asarray(targets)),
         lambda p: losses.classwise_regression_loss(
             p, torch.from_numpy(reg_labels), torch.from_numpy(targets)),
         reg),
    ]
    for jf, tf, a in cases:
        jv, jg = jax.value_and_grad(jf)(jnp.asarray(a))
        ta = torch.from_numpy(a).requires_grad_()
        tv = tf(ta)
        tv.backward()
        np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-7)
    assert losses.accuracy(torch.from_numpy(logits),
                           torch.from_numpy(act_labels)).item() == \
        pytest.approx(float(jl.accuracy(jnp.asarray(logits),
                                        jnp.asarray(act_labels))))


@pytest.mark.parametrize("cfg,standalone", [((1, 1, 1), True),
                                            ((1, (1, 2), 1), True),
                                            ((1, (1, 2), 1), False)])
def test_stpp_train_pool_matches_jax(cfg, standalone):
    rng = np.random.RandomState(1)
    ft = rng.randn(4, 9, 16).astype(np.float32)
    scaling = rng.rand(4, 2).astype(np.float32)
    ja, jc = j_stpp_train_pool(jnp.asarray(ft), jnp.asarray(scaling),
                               (2, 7, 9), JStppConfig.from_raw(cfg),
                               standalone_classifier=standalone)
    ta, tc = stpp_train_pool(torch.from_numpy(ft), torch.from_numpy(scaling),
                             (2, 7, 9), StppConfig.from_raw(cfg),
                             standalone_classifier=standalone)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)


def _batches(prop_file, random_shift, videos=(0, 1), width=48, height=40,
             crop=32):
    """The same training batch from the JAX package and from the port."""
    jds = JSSNDataset(prop_file, JSamplingConfig(), body_seg=1, aug_seg=1)
    ds = SSNDataset(prop_file, SamplingConfig(), body_seg=1, aug_seg=1)
    jaug = jtr.Compose([jtr.GroupScale(height), jtr.GroupCenterCrop(crop),
                        jtr.GroupRandomHorizontalFlip()])
    aug = transforms.Compose([transforms.GroupScale(height),
                              transforms.GroupCenterCrop(crop),
                              transforms.GroupRandomHorizontalFlip()])
    jb = jpipe.assemble_train_batch(
        jds, list(videos), jpipe.SyntheticFrameProvider(width, height), jaug,
        np.random.RandomState(7), random_shift=random_shift)
    tb = pipeline.assemble_train_batch(
        ds, list(videos), pipeline.SyntheticFrameProvider(width, height), aug,
        np.random.RandomState(7), random_shift=random_shift)
    return jb, tb


@pytest.mark.parametrize("random_shift", [True, False])
def test_training_batch_byte_equal(tmp_path, random_shift):
    """get_training_sample + frames + center crop + random flip: every
    array of the batch equal to the JAX package's."""
    jb, tb = _batches(write_proposal_list(tmp_path / "p.txt"), random_shift)
    assert set(jb) == set(tb)
    assert tb["frames"].shape == (16, 3, 32, 32, 3)
    for key in jb:
        assert tb[key].dtype == jb[key].dtype, key
        np.testing.assert_array_equal(tb[key], jb[key])


def test_optimizer_groups_match_jax():
    model = SSN(num_class=3, base_model="TinyConv")
    labels = label_params(model)
    assert labels["base_model.conv1_7x7_s2.weight"] == "first_conv_weight"
    assert labels["base_model.conv1_7x7_s2.bias"] == "first_conv_bias"
    assert labels["base_model.conv2_3x3.weight"] == "normal_weight"
    assert labels["activity_fc.weight"] == "normal_weight"
    assert labels["activity_fc.bias"] == "normal_bias"
    assert labels["base_model.conv1_7x7_s2_bn.weight"] == "bn_frozen"
    assert labels["base_model.conv2_3x3_bn.bias"] == "bn_frozen"
    opt = make_optimizer(model, 0.1, [1], 1)
    groups = {g["name"]: (g["lr"], g["weight_decay"])
              for g in opt.sgd.param_groups}
    assert groups == {"first_conv_weight": (0.1, 5e-4),
                      "first_conv_bias": (0.2, 0.0),
                      "normal_weight": (0.1, 5e-4),
                      "normal_bias": (0.2, 0.0)}
    bn = {id(p) for n, p in model.named_parameters() if "_bn." in n}
    assert bn and not bn & {id(p) for p in opt.params}


def test_two_train_steps_match_jax(tmp_path):
    """The whole slice: BNInception SSN (64^2 crops, 1+1+1 segments, one
    video of 8 proposals, dropout 0) takes two SGD steps from the same
    weights on the same batch, the second past an LR boundary. Metrics
    within rtol 1e-4; every parameter's update within 1e-3 of its largest
    JAX update (float32 conv backward sums in different orders) plus four
    float32 ulps of its largest weight (the rounding of ``p + update``)."""
    jb, tb = _batches(write_proposal_list(tmp_path / "p.txt"), True,
                      videos=(0,), width=80, height=64, crop=64)
    K, seg = 3, dict(starting_segment=1, course_segment=1, ending_segment=1)
    jm = JSSN(num_class=K, base_model="BNInception", dropout=0.0, **seg)
    v = jitted_init(jm, {"params": jax.random.PRNGKey(0)},
                    jnp.zeros((1, 3, 64, 64, 3)), jnp.ones((1, 2)),
                    train=False)
    v = _jitter(v, seed=4)
    sampling = JSamplingConfig()
    tx = j_make_optimizer(base_lr=0.01, lr_steps=[1], steps_per_epoch=1)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]))
    _, _, jspec = j_get_backbone("BNInception", "RGB")
    jstep = j_make_train_step(jm, tx, sampling, jspec, JLossWeights(),
                              donate=False)

    model = SSN(num_class=K, base_model="BNInception", dropout=0.0, **seg)
    model.load_state_dict(state_dict_from_jax(
        jax.device_get(v["params"]), jax.device_get(v["batch_stats"])))
    opt = make_optimizer(model, base_lr=0.01, lr_steps=[1],
                         steps_per_epoch=1)
    step = make_train_step(model, opt, SamplingConfig(), LossWeights())
    batch = batch_to_device(tb, "cpu")

    before_j = state_dict_from_jax(jax.device_get(state.params),
                                   jax.device_get(v["batch_stats"]))
    before_t = {k: t.clone() for k, t in model.state_dict().items()}
    for i in range(2):
        state, jmet = jstep(state, {k: jnp.asarray(a) for k, a in jb.items()},
                            jax.random.PRNGKey(0))
        met = step(batch)
        for name, val in jmet.items():
            np.testing.assert_allclose(met[name].item(), float(val),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {name}")
        after_j = state_dict_from_jax(jax.device_get(state.params),
                                      jax.device_get(v["batch_stats"]))
        after_t = model.state_dict()
        for name, t in after_t.items():
            if not t.is_floating_point():
                continue
            dj = (after_j[name] - before_j[name]).numpy()
            dt = (t - before_t[name]).numpy()
            tol = (1e-3 * np.abs(dj).max()
                   + 4 * np.finfo(np.float32).eps * t.abs().max().item())
            assert np.abs(dt - dj).max() <= tol, (i, name)
        before_j = after_j
        before_t = {k: t.clone() for k, t in after_t.items()}
    assert opt.lr_factor() == pytest.approx(0.1)
