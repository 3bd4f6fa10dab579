"""Port parity, the ResNet and VGG backbones, against the JAX package on
the CPU:

* features of a fabricated torchvision-named state dict, loaded as it is
  into the port and through the JAX converter into flax: ResNet-18/50 at
  64^2 (RGB and Flow), VGG-11 and VGG-11-BN at 224^2 (one frame; the CHW
  flatten before fc6), at the float-feature bound of tests/
  test_torch_parity.py (atol 1e-4, rtol 1e-3);
* the weight bridge both ways: flax -> port (``state_dict_from_jax``) and
  port -> flax (the JAX ``convert_torch_ssn_checkpoint`` reading the
  port's ``.pt``), exactly, onto the JAX SSN's own tree;
* a ResNet-18 SSN train step with ``bn_mode`` partial: loss, every
  gradient and the running statistics within 1e-4 of each tensor's
  largest value;
* the optimizer group of every parameter against JAX's ``label_params``,
  for every backbone family;
* VGG's classifier dropout: off in eval mode, drawn from the generator in
  train mode; the registry's names and input specs.
"""

from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from action_detection_tpu.config import SamplingConfig as JSamplingConfig
from action_detection_tpu.models import SSN as JSSN
from action_detection_tpu.models.backbones import get_backbone as j_get_backbone
from action_detection_tpu.models.convert import (
    convert_torch_backbone_state as j_convert_backbone,
    convert_torch_ssn_checkpoint as j_convert_ssn)
from action_detection_tpu.train import LossWeights as JLossWeights
from action_detection_tpu.train.optim import label_params as j_label_params
from action_detection_tpu.train.trainer import make_loss_fn as j_make_loss_fn

from action_detection_torch.config import SamplingConfig
from action_detection_torch.data import pipeline, transforms
from action_detection_torch.data.ssn_dataset import SSNDataset
from action_detection_torch.models import SSN, seeded_init, state_dict_from_jax
from action_detection_torch.models.backbones import get_backbone
from action_detection_torch.models.backbones.common import commit_batch_stats
from action_detection_torch.ops import pooling
from action_detection_torch.train import (LossWeights, batch_to_device,
                                          make_loss_fn, save_checkpoint)
from action_detection_torch.train.optim import label_params

from tests.test_datasets import write_proposal_list
from tests.test_torch_port_train_optim import (  # noqa: F401 (fixture)
    SEG, _close, _jb, one_torch_thread)


def torchvision_state(arch: str, modality: str = "RGB", seed: int = 0):
    """A fabricated torchvision-style backbone state dict (the port's names
    are torchvision's): seeded weights (VGG's fc6/fc7, 119M weights, keep
    torch's own init) with random conv and FC biases."""
    torch.manual_seed(seed)
    bb = get_backbone(arch, modality)[0]
    seeded_init(getattr(bb, "features", bb), seed=seed)
    rng = np.random.RandomState(seed + 1)
    with torch.no_grad():
        for m in bb.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) \
                    and m.bias is not None:
                m.bias.copy_(torch.from_numpy(
                    (0.05 * rng.randn(*m.bias.shape)).astype(np.float32)))
    return bb.state_dict()


@pytest.mark.parametrize("arch,hw,modality", [
    ("resnet18", 64, "RGB"), ("resnet50", 64, "RGB"),
    ("resnet18", 64, "Flow"), ("vgg11", 224, "RGB"),
    ("vgg11_bn", 224, "RGB")])
def test_features_match_flax(arch, hw, modality):
    """The same torchvision-named weights in both packages give the same
    features; the flax tree of the JAX converter comes back to the port's
    state dict exactly through ``state_dict_from_jax``."""
    sd = torchvision_state(arch, modality)
    params, stats = j_convert_backbone(sd, arch)
    back = state_dict_from_jax(params, stats)
    assert set(back) == set(sd)
    for k, t in sd.items():
        if t.is_floating_point():
            assert torch.equal(back[k], t), k
    jbb, jdim, jspec = j_get_backbone(arch, modality)
    c = 3 if modality == "RGB" else 10
    n = 1 if arch.startswith("vgg") else 3
    x = np.random.RandomState(2).randn(n, hw, hw, c).astype(np.float32)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    ref = np.asarray(jax.jit(jbb.apply)(variables, jnp.asarray(x)))

    bb, dim, spec = get_backbone(arch, modality)
    bb.load_state_dict(sd)
    with torch.no_grad():
        got = bb.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (n, dim) and dim == jdim
    assert astuple(spec) == astuple(jspec)
    assert np.abs(ref).max() > 0.1       # features far from zero
    print(f"{arch} {modality} {hw}^2: max |d| {np.abs(got - ref).max():.2e} "
          f"of max |f| {np.abs(ref).max():.3f}")
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def _jssn(arch: str, hw: int, **kw):
    """A flax SSN and its parameter tree's shapes (``jax.eval_shape``: no
    weights are made)."""
    jm = JSSN(num_class=3, base_model=arch, dropout=0.0, **SEG, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3, hw, hw, 3)),
        jnp.ones((1, 2)), train=False))
    return jm, shapes


@pytest.mark.parametrize("arch,hw", [("resnet18", 64), ("resnet50", 64),
                                     ("vgg11", 224), ("vgg11_bn", 224)])
def test_port_checkpoint_reads_into_the_jax_tree(tmp_path, arch, hw):
    """port -> flax: the JAX ``convert_torch_ssn_checkpoint`` reads the
    port's ``.pt`` into exactly the tree the JAX SSN has (every scope and
    leaf shape), and ``state_dict_from_jax`` maps it back bit for bit.
    VGG's 133M weights are not written: its state dict's names and shapes
    (meta tensors, as zero-stride arrays) go through the converter, and
    test_features_match_flax holds its values both ways."""
    _, shapes = _jssn(arch, hw)
    if arch.startswith("vgg"):
        with torch.device("meta"):
            sd = SSN(num_class=3, base_model=arch, dropout=0.0,
                     **SEG).state_dict()
        ck = j_convert_ssn({"state_dict": {
            k: np.broadcast_to(np.float32(0), t.shape)
            for k, t in sd.items()}}, arch)
    else:
        tm = seeded_init(SSN(num_class=3, base_model=arch, dropout=0.0,
                             **SEG), seed=3)
        rs = np.array([[0.1, -0.2], [1.0, 2.0]], np.float32)
        path = str(tmp_path / "m.pt")
        save_checkpoint(path, tm.state_dict(), rs, arch=arch, epoch=2)
        ck = j_convert_ssn(torch.load(path, weights_only=False), arch)
        np.testing.assert_array_equal(ck["reg_stats"], rs)
        back = state_dict_from_jax(ck["params"], ck["batch_stats"])
        sd = tm.state_dict()
        assert set(back) == set(sd)
        for k, t in sd.items():
            if t.is_floating_point():
                assert torch.equal(back[k], t), k
    for tree, want in ((ck["params"], shapes["params"]),
                       (ck["batch_stats"], shapes.get("batch_stats", {}))):
        got_shapes = jax.tree_util.tree_map(np.shape, tree)
        want_shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), want)
        assert got_shapes == want_shapes


@pytest.mark.parametrize("arch,hw", [
    ("BNInception", 64), ("InceptionV3", 75), ("TinyConv", 32),
    ("resnet18", 64), ("resnet50", 64), ("vgg11", 224), ("vgg11_bn", 224)])
def test_optimizer_groups_match_jax(arch, hw):
    """Every parameter's group equals JAX's ``label_params`` of the same
    SSN: ``conv1`` is a first conv at the backbone's top level only,
    ``features.0`` is VGG's, BN layers (``features.1``, ``downsample.1``)
    are frozen whatever their name. Each JAX leaf is tagged with its index
    and carried through ``state_dict_from_jax`` to the port's name."""
    _, shapes = _jssn(arch, hw)
    labels = j_label_params(shapes["params"])
    flat, treedef = jax.tree_util.tree_flatten(labels)
    tagged = jax.tree_util.tree_unflatten(treedef, [
        np.full((1,) * len(s.shape), i, np.float32) for i, s in enumerate(
            jax.tree_util.tree_leaves(shapes["params"]))])
    want = {k: flat[int(t.reshape(-1)[0])]
            for k, t in state_dict_from_jax(tagged).items()}
    got = label_params(SSN(num_class=3, base_model=arch, dropout=0.0, **SEG))
    assert got == want
    assert "first_conv_weight" in got.values()


@pytest.fixture(scope="module")
def batch64(tmp_path_factory):
    """A training batch of 2 videos x 8 proposals x 3 segments at 64^2 (the
    training augmentation), as numpy."""
    prop = write_proposal_list(tmp_path_factory.mktemp("b") / "p.txt")
    ds = SSNDataset(prop, SamplingConfig(), body_seg=1, aug_seg=1)
    prov = pipeline.SyntheticFrameProvider(96, 80)
    aug = transforms.get_train_augmentation(64, "RGB")
    return pipeline.assemble_train_batch(ds, [0, 1], prov, aug,
                                         np.random.RandomState(0))


def _jax_step(jm, jp, js, batch, dtype):
    """The JAX SSN's loss, gradients and new batch statistics in
    ``dtype``."""
    cast = lambda t: jax.tree_util.tree_map(       # noqa: E731
        lambda a: np.asarray(a, dtype), t)
    jloss = j_make_loss_fn(jm, JSamplingConfig(),
                           j_get_backbone("resnet18", "RGB")[2],
                           JLossWeights())
    (loss, (_, new)), grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True), static_argnums=4)(
        cast(jp), cast(js), _jb(batch), jax.random.PRNGKey(0), True)
    return float(loss), jax.device_get(grads), jax.device_get(new)


def test_resnet18_partial_bn_train_step_matches_jax(batch64, monkeypatch):
    """A ResNet-18 SSN train step with ``bn_mode`` partial (the stem's
    ``bn1`` normalizes with batch statistics).

    In float32, as the trainer runs: the loss within rtol 1e-5, the running
    statistics after the step within 1e-4 of each tensor's largest value,
    and only ``bn1``'s move. The gradients are held in float64 on both
    sides, every tensor within 1e-6 of its largest value: in float32 a few
    of the ~9M ReLU inputs of this step lie within rounding of zero, and
    the two frameworks round them to different sides, which moves the
    gradients of the layers below by up to ~3e-4 of their largest value
    (the port's float32 gradients and JAX's are each that far from the
    float64 ones, at different layers). In float64 the port's max pools
    take torch's own backward, A1's plain version (A1 takes float32 and
    bfloat16)."""
    jm, shapes = _jssn("resnet18", 64, bn_mode="partial")
    params, stats = j_convert_backbone(torchvision_state("resnet18", seed=4),
                                       "resnet18")
    rng = np.random.RandomState(5)
    heads = {k: {"kernel": (0.01 * rng.randn(*v["kernel"].shape)).astype(
                 np.float32),
                 "bias": (0.05 * rng.randn(*v["bias"].shape)).astype(
                     np.float32)}
             for k, v in shapes["params"].items() if k != "backbone"}
    jp, js = {"backbone": params, **heads}, {"backbone": stats}
    jl, _, jnew = _jax_step(jm, jp, js, batch64, np.float32)
    with jax.enable_x64(True):
        jm64, _ = _jssn("resnet18", 64, bn_mode="partial",
                        dtype=jnp.float64)
        _, jg64, _ = _jax_step(jm64, jp, js, batch64, np.float64)

    def port(dtype):
        tm = SSN(num_class=3, base_model="resnet18", dropout=0.0,
                 bn_mode="partial", **SEG)
        tm.load_state_dict(state_dict_from_jax(jp, js))
        if dtype == torch.float64:
            tm.double()

            def features(frames, generator=None):   # no float32 cast
                x = frames.double().permute(0, 3, 1, 2)
                for stage in tm.base_model._stages():
                    x = stage(x)
                return x.mean(dim=(2, 3))

            monkeypatch.setattr(tm, "features", features)
            monkeypatch.setattr(pooling._MaxPool2d, "apply", staticmethod(
                lambda x, k, s, p: pooling._reduce_max(x, k, s, p)))
        total, _ = make_loss_fn(tm, SamplingConfig(), LossWeights())(
            batch_to_device(batch64, "cpu"), True)
        total.backward()
        commit_batch_stats(tm)
        return tm, total.item()

    tm, loss = port(torch.float32)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    want = state_dict_from_jax(jp, jnew)
    got = tm.state_dict()
    stats_keys = [k for k in got if k.endswith(("running_mean",
                                                "running_var"))]
    _close({k: got[k] for k in stats_keys},
           {k: want[k] for k in stats_keys}, 1e-4, "running stats")
    start = state_dict_from_jax(jp, js)
    moved = {k.rsplit(".", 1)[0] for k in stats_keys
             if not torch.equal(got[k], start[k])}
    assert moved == {"base_model.bn1"}

    tm64, _ = port(torch.float64)
    want_g = {k: torch.from_numpy(np.array(v)) for k, v in _flat(
        jg64).items()}
    got_g = {k: p.grad for k, p in tm64.named_parameters()}
    assert set(got_g) == set(want_g)
    _close(got_g, want_g, 1e-6, "gradients")


def _flat(grads) -> dict:
    """A flax gradient tree in float64, keyed by the port's names (the
    weight bridge's mapping, without its float32 cast)."""
    tagged = jax.tree_util.tree_map(lambda a: np.zeros((1,) * a.ndim), grads)
    leaves = jax.tree_util.tree_leaves(grads)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(tagged)):
        leaf[...] = i
    out = {}
    for k, t in state_dict_from_jax(tagged).items():
        a = np.asarray(leaves[int(t.reshape(-1)[0])], np.float64)
        out[k] = (a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                  if a.ndim == 2 else a)
    return out


def test_vgg_classifier_dropout_uses_the_generator():
    """VGG-11 in train mode drops fc6/fc7 units with masks drawn from the
    generator it is given (the same generator: the same features), keeps
    them all in eval mode and with ``classifier_dropout=0``."""
    from action_detection_torch.models.backbones.vgg import VGG

    torch.manual_seed(0)
    bb = VGG("vgg11")
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 224, 224, 3).astype(np.float32))
    with torch.no_grad():
        ev = bb.eval()(x)
        bb.train()
        a = bb(x, torch.Generator().manual_seed(3))
        b = bb(x, torch.Generator().manual_seed(3))
        c = bb(x, torch.Generator().manual_seed(4))
        bb.classifier_dropout = 0.0
        off = bb(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(off, ev)
    # fc7's dropout zeroes about half of what its ReLU leaves
    assert (a == 0).float().mean() > (ev == 0).float().mean() + 0.2


def test_registry_knows_every_jax_name():
    """Every name the JAX registry builds builds here (on the meta device:
    no weights are made) with its feature dim and input spec; other names
    raise ValueError, as JAX's do."""
    for name in ("resnet34", "resnet101", "resnet152", "vgg13", "vgg16_bn",
                 "vgg19", "vgg19_bn"):
        for modality in ("RGB", "Flow"):
            with torch.device("meta"):
                _, dim, spec = get_backbone(name, modality)
            _, jdim, jspec = j_get_backbone(name, modality)
            assert dim == jdim and astuple(spec) == astuple(jspec), name
    for name in ("resnet51", "vgg12", "vgg16_gn", "alexnet"):
        with pytest.raises(ValueError, match="Unknown base model"):
            get_backbone(name)
        with pytest.raises(ValueError, match="Unknown base model"):
            j_get_backbone(name)
