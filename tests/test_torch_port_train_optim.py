"""Port parity, the training CLIs' optimizer and weights, against the JAX
functions on the CPU: ``--iter_size`` against ``optax.MultiSteps``
(parameters within 1e-6 of each tensor's largest value, nothing moves
between updates); the LR at resume (exact, float32 to the bit); init
weights from reference ``.pth`` state dicts (``module.``/``base_model.``,
RGB -> Flow) exactly equal to the JAX ``apply_init_weights``; the
pretrained-init cache; and the checkpoint with ``best_loss`` and
``model_best``. (``bn_mode``, ``--bf16`` and ``--remat``:
tests/test_torch_port_train_bn.py.)"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from action_detection_tpu import config as jconfig
from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models import jitted_init
from action_detection_tpu.models.backbones import get_backbone as j_get_backbone
from action_detection_tpu.models.convert import (
    convert_torch_ssn_checkpoint as j_convert_ssn)
from action_detection_tpu.train import LossWeights as JLossWeights
from action_detection_tpu.train import TrainState
from action_detection_tpu.train import checkpoint_name as j_checkpoint_name
from action_detection_tpu.train import load_checkpoint as j_load_checkpoint
from action_detection_tpu.train import make_optimizer as j_make_optimizer
from action_detection_tpu.train import make_train_step as j_make_train_step
from action_detection_tpu.train.init_weights import (
    apply_init_weights as j_apply_init_weights)

from action_detection_torch import config
from action_detection_torch.config import SamplingConfig
from action_detection_torch.data import pipeline, transforms
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.models import (SSN, seeded_init,
                                           state_dict_from_jax)
from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.train import (LossWeights, batch_to_device,
                                          checkpoint_name, load_checkpoint,
                                          make_optimizer, make_train_step,
                                          save_checkpoint)
from action_detection_torch.train.init_weights import apply_init_weights

from tests.test_datasets import write_proposal_list
from tests.test_torch_port_int8 import _jitter

SEG = dict(starting_segment=1, course_segment=1, ending_segment=1)
JSPEC = j_get_backbone("TinyConv", "RGB")[2]


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """Four TinyConv training batches (2 videos x 8 proposals x 3 segments
    of 32^2, the training augmentation), as numpy."""
    prop = write_proposal_list(tmp_path_factory.mktemp("b") / "p.txt")
    ds = SSNDataset(prop, SamplingConfig(), body_seg=1, aug_seg=1)
    prov = pipeline.SyntheticFrameProvider(48, 40)
    aug = transforms.get_train_augmentation(32, "RGB")
    return [pipeline.assemble_train_batch(ds, vids, prov, aug,
                                          np.random.RandomState(seed))
            for seed, vids in enumerate(([0, 1], [1, 2], [2, 0], [0, 2]))]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _biased(variables, seed):
    """Conv and head biases of N(0, 0.05) in place of flax's zeros, as in
    trained weights (so every tensor has a scale of its own)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        if path[-1].key == "bias" and not path[-2].key.endswith("_bn"):
            return jnp.asarray((0.05 * rng.randn(*x.shape)).astype(np.float32))
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _pair(bn_mode="frozen", bf16=False, arch="TinyConv", hw=32):
    """A flax SSN (jittered BN, random biases) and the port's twin with its
    weights."""
    jm = JSSN(num_class=3, base_model=arch, dropout=0.0, bn_mode=bn_mode,
              dtype=jnp.bfloat16 if bf16 else jnp.float32, **SEG)
    v = _biased(_jitter(jitted_init(jm, {"params": jax.random.PRNGKey(0)},
                                    jnp.zeros((1, 3, hw, hw, 3)),
                                    jnp.ones((1, 2)), train=False), seed=4),
                seed=5)
    tm = SSN(num_class=3, base_model=arch, dropout=0.0, bn_mode=bn_mode,
             dtype=torch.bfloat16 if bf16 else torch.float32, **SEG)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(v["params"]),
                                           jax.device_get(v["batch_stats"])))
    return jm, v, tm


def _close(got: dict, want: dict, rel: float, what: str) -> None:
    """Every float tensor within ``rel`` of the largest |value| of the JAX
    one."""
    for name, w in want.items():
        if not w.is_floating_point():
            continue
        scale = w.abs().max().item()
        err = (got[name] - w).abs().max().item()
        assert err <= rel * scale + 1e-30, (what, name, err, scale)


def _jstate(v, tx):
    return TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                      batch_stats=v["batch_stats"],
                      opt_state=tx.init(v["params"]))


def test_iter_size_matches_optax_multisteps(batches):
    """--iter_size 2, clip 20, weight decay, an LR boundary after the first
    update: four mini-steps = two updates. After each, every parameter
    within 1e-6 of its largest value; after the 1st and 3rd nothing moved,
    on either side."""
    jm, v, tm = _pair()
    kw = dict(base_lr=0.01, lr_steps=[1], steps_per_epoch=2,
              clip_gradient=20.0, iter_size=2)
    tx = j_make_optimizer(**kw)
    state = _jstate(v, tx)
    jstep = j_make_train_step(jm, tx, JSamplingConfig(), JSPEC,
                              JLossWeights(), donate=False)
    opt = make_optimizer(tm, **kw)
    step = make_train_step(tm, opt, SamplingConfig(), LossWeights())
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    moved = []
    for i, b in enumerate(batches):
        state, jmet = jstep(state, _jb(b), jax.random.PRNGKey(0))
        met = step(batch_to_device(b, "cpu"))
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-5)
        want = state_dict_from_jax(jax.device_get(state.params),
                                   jax.device_get(state.batch_stats))
        got = tm.state_dict()
        _close(got, want, 1e-6, f"mini-step {i}")
        same = all(torch.equal(got[k], before[k]) for k in got)
        moved.append(not same)
        before = {k: t.clone() for k, t in got.items()}
    assert moved == [False, True, False, True]
    assert opt.decays() == 1 and opt.count == 2


@pytest.mark.parametrize("iter_size", [1, 2])
@pytest.mark.parametrize("start_epoch", [0, 3, 6])
def test_lr_at_resume_matches_jax(start_epoch, iter_size):
    """lr_steps [3, 6], 4 steps an epoch, resumed at epoch 0/3/6: each
    call's update of a unit gradient (momentum and decay 0) equals the JAX
    optimizer's bit for bit, weight (x1) and bias (x2), over 8 epochs."""
    kw = dict(base_lr=0.001, lr_steps=[3, 6], steps_per_epoch=4,
              momentum=0.0, weight_decay=0.0, iter_size=iter_size,
              start_epoch=start_epoch)
    tx = j_make_optimizer(**kw)
    params = {"activity_fc": {"kernel": jnp.zeros((1, 1)),
                              "bias": jnp.zeros((1,))}}
    st = tx.init(params)
    update = jax.jit(tx.update)
    model = nn.Module()
    model.activity_fc = nn.Linear(1, 1)
    opt = make_optimizer(model, **kw)
    lrs = []
    for _ in range(32):
        upd, st = update(jax.tree_util.tree_map(jnp.ones_like, params),
                         st, params)
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
                p.grad = torch.ones_like(p)
        opt.step()
        for got, want in ((model.activity_fc.weight, upd["activity_fc"]
                           ["kernel"]),
                          (model.activity_fc.bias, upd["activity_fc"]
                           ["bias"])):
            np.testing.assert_array_equal(
                got.detach().numpy().reshape(-1),
                np.asarray(want).reshape(-1))
        lrs.append(-float(np.asarray(upd["activity_fc"]["kernel"])[0, 0]))
    applied = [lr for lr in lrs if lr]
    assert len(applied) == 32 // iter_size
    # starting decayed at a resume past a boundary
    first = {0: 0.001, 3: 0.0001, 6: 0.00001}[start_epoch]
    assert applied[0] == pytest.approx(first, rel=1e-6)


class _Args:
    def __init__(self, **kw):
        self.init_weights, self.kinetics_pretrain = "", False
        self.arch, self.modality = "TinyConv", "RGB"
        self.__dict__.update(kw)


def _reference_sd(arch: str, seed: int) -> dict:
    """A fabricated reference RGB backbone state dict: every key of the
    backbone under ``module.base_model.``, fan-in-scaled conv weights,
    running statistics, ``num_batches_tracked``."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, t in get_backbone(arch, "RGB")[0].state_dict().items():
        shape = tuple(t.shape)
        if k.endswith("num_batches_tracked"):
            a = torch.tensor(1)
        elif k.endswith("running_var"):
            a = torch.from_numpy((1 + rng.rand(*shape)).astype(np.float32))
        elif t.dim() == 4:
            a = torch.from_numpy((rng.randn(*shape) / np.sqrt(
                np.prod(shape[1:]))).astype(np.float32))
        else:
            a = torch.from_numpy((0.1 * rng.randn(*shape)).astype(np.float32))
        out["module.base_model." + k] = a
    return out


@pytest.mark.parametrize("arch,modality", [("TinyConv", "RGB"),
                                           ("TinyConv", "Flow"),
                                           ("BNInception", "RGB"),
                                           ("BNInception", "Flow")])
def test_init_weights_from_reference_pth_match_jax(tmp_path, arch,
                                                   modality):
    """A fabricated reference RGB backbone .pth.tar (``module.base_model.``
    keys, running statistics) -> --init_weights: the whole model's state
    equal to the JAX apply_init_weights -> state_dict_from_jax, exactly;
    for Flow through the cross-modality first conv (3 -> 10 channels). Both
    start from one seeded model (the JAX tree by the JAX converter)."""
    path = str(tmp_path / "imagenet.pth.tar")
    torch.save({"state_dict": _reference_sd(arch, 5), "epoch": 3}, path)
    tm = seeded_init(SSN(num_class=3, base_model=arch, modality=modality,
                         dropout=0.0, **SEG), seed=2)
    ck = j_convert_ssn({"state_dict": tm.state_dict()}, arch)
    state = TrainState(step=0, params=ck["params"],
                       batch_stats=ck["batch_stats"], opt_state=None)
    args = _Args(init_weights=path, arch=arch, modality=modality)
    new = j_apply_init_weights(state, args, None, j_load_checkpoint)
    want = state_dict_from_jax(new.params, new.batch_stats)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    apply_init_weights(tm, args, None)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if w.is_floating_point():
            assert torch.equal(got[k], w), k
            if k.startswith("base_model."):
                assert not torch.equal(got[k], before[k]), k
    c = 3 if modality == "RGB" else 10
    assert got["base_model.conv1_7x7_s2.weight"].shape[1] == c


def test_init_weights_from_port_checkpoint_and_refusals(tmp_path, capsys):
    """A port .pt checkpoint as --init_weights grafts its backbone (Flow
    from RGB through the cross-modality first conv) and leaves the heads;
    a missing file is a message, a file missing backbone weights raises."""
    rgb = SSN(num_class=3, base_model="TinyConv", **SEG)
    torch.manual_seed(1)
    for p in rgb.parameters():
        nn.init.normal_(p)
    path = str(tmp_path / "rgb.pt")
    save_checkpoint(path, rgb.state_dict(), np.zeros((2, 2)), arch="TinyConv")
    flow = SSN(num_class=3, base_model="TinyConv", modality="Flow", **SEG)
    heads = {k: t.clone() for k, t in flow.state_dict().items()
             if not k.startswith("base_model.")}
    apply_init_weights(flow, _Args(init_weights=path, modality="Flow"), None)
    fsd, rsd = flow.state_dict(), rgb.state_dict()
    for k, t in fsd.items():
        if k in heads:
            assert torch.equal(t, heads[k]), k
        elif k == "base_model.conv1_7x7_s2.weight":
            assert t.shape[1] == 10
            torch.testing.assert_close(
                t, rsd[k].mean(dim=1, keepdim=True).expand_as(t))
        elif t.is_floating_point():
            assert torch.equal(t, rsd[k]), k
    assert "cross-modality first conv: 3 -> 10" in capsys.readouterr().out
    apply_init_weights(flow, _Args(init_weights=str(tmp_path / "nope.pt")),
                       None)
    assert "no weights file found" in capsys.readouterr().out
    torch.save({"state_dict": {"conv2_3x3.weight": torch.zeros(1)}},
               str(tmp_path / "partial.pth"))
    with pytest.raises(ValueError, match="missing"):
        apply_init_weights(flow, _Args(
            init_weights=str(tmp_path / "partial.pth")), None)


def test_pretrained_cache_resolution_matches_jax(tmp_path, monkeypatch,
                                                 capsys):
    """resolve_pretrained_init against a temporary $ADT_MODEL_CACHE, as the
    JAX one: None for RGB, KeyError for an arch with no URL,
    FileNotFoundError naming the path, the path once cached; then
    --kinetics_pretrain grafts the cached file and an uncached Flow init
    warns and keeps the seeded weights."""
    monkeypatch.setenv("ADT_MODEL_CACHE", str(tmp_path))
    for dataset in ("thumos14", "activitynet1.2"):
        cfg, jcfg = config.get_configs(dataset), jconfig.get_configs(dataset)
        assert cfg.flow_init == jcfg.flow_init
        assert cfg.kinetics_pretrain == jcfg.kinetics_pretrain
        assert config.resolve_pretrained_init(cfg, "BNInception",
                                              "RGB") is None
        with pytest.raises(KeyError):
            config.resolve_pretrained_init(cfg, "TinyConv", "RGB",
                                           kinetics=True)
        for arch, mod, kin in (("BNInception", "Flow", False),
                               ("InceptionV3", "RGB", True)):
            with pytest.raises(FileNotFoundError) as ei:
                config.resolve_pretrained_init(cfg, arch, mod, kinetics=kin)
            with pytest.raises(FileNotFoundError) as ej:
                jconfig.resolve_pretrained_init(jcfg, arch, mod,
                                                kinetics=kin)
            name = str(ej.value).splitlines()[0].split(": ", 1)[1]
            assert name in str(ei.value) and str(tmp_path) in name
    assert config.pretrained_cache_dir() == jconfig.pretrained_cache_dir()

    url = "https://example.invalid/zoo/tinyconv_kinetics-feedc0de.pth"
    cfg = dataclasses.replace(config.get_configs("thumos14"),
                              kinetics_pretrain={"TinyConv": {"RGB": url}})
    model = SSN(num_class=3, base_model="TinyConv", **SEG)
    src = {k[len("base_model."):]: torch.randn_like(t) if
           t.is_floating_point() else t
           for k, t in model.state_dict().items()
           if k.startswith("base_model.")}
    torch.save(src, str(tmp_path / url.rsplit("/", 1)[-1]))
    apply_init_weights(model, _Args(kinetics_pretrain=True), cfg)
    for k, t in src.items():
        if t.is_floating_point():
            assert torch.equal(model.base_model.state_dict()[k], t), k
    flow = SSN(num_class=3, base_model="BNInception", modality="Flow", **SEG)
    before = {k: t.clone() for k, t in flow.state_dict().items()}
    apply_init_weights(flow, _Args(arch="BNInception", modality="Flow"),
                       config.get_configs("thumos14"))
    assert "not cached" in capsys.readouterr().out
    assert all(torch.equal(t, before[k]) for k, t in
               flow.state_dict().items())


def test_checkpoint_best_loss_and_model_best(tmp_path):
    """The JAX naming (.pt for .msgpack), best_loss round trip, the
    model_best copy; a checkpoint without best_loss loads as inf."""
    for pref, arch, mod, fname in (("", "BNInception", "RGB",
                                    "checkpoint.pt"),
                                   ("_x", "TinyConv", "Flow",
                                    "binary_checkpoint.pt")):
        assert checkpoint_name(pref, "thumos14", arch, mod, fname) == \
            j_checkpoint_name(pref, "thumos14", arch, mod,
                              fname.replace(".pt", ".msgpack")) \
            .replace(".msgpack", ".pt")
    model = SSN(num_class=3, base_model="TinyConv", **SEG)
    path = str(tmp_path / checkpoint_name("", "thumos14", "TinyConv", "RGB"))
    save_checkpoint(path, model.state_dict(), np.ones((2, 2)),
                    arch="TinyConv", epoch=2, best_loss=0.25, is_best=True)
    best = str(tmp_path / "ssn_thumos14_TinyConv_rgb_model_best.pt")
    assert os.path.exists(best)
    for p in (path, best):
        ck = load_checkpoint(p)
        assert ck["best_loss"] == 0.25 and ck["epoch"] == 2
        np.testing.assert_array_equal(ck["reg_stats"], np.ones((2, 2)))
    other = str(tmp_path / "weights.pt")
    save_checkpoint(other, model.state_dict(), None, best_loss=1.5,
                    is_best=True)
    assert os.path.exists(str(tmp_path / "weights_model_best.pt"))
    torch.save({"state_dict": model.state_dict(), "reg_stats": None,
                "arch": "TinyConv", "epoch": 1}, other)
    assert load_checkpoint(other)["best_loss"] == float("inf")
