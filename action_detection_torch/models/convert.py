"""The weight bridge from the JAX package, and a seeded random init.

* :func:`state_dict_from_jax` maps flax ``params``/``batch_stats`` trees
  (given as numpy) onto the port's ``state_dict``: conv ``kernel (H, W, I,
  O)`` -> ``weight (O, I, H, W)``, Dense ``kernel (I, O)`` -> ``weight (O,
  I)``, BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
  running_var``. Module scopes collapse to the flat Caffe blob names
  (BNInception); InceptionV3's tf-slim names keep their module path, flax
  ``Mixed_5b/branch1x1_conv`` becoming ``Mixed_5b.branch1x1.conv``; ResNet
  and VGG get torchvision's names back (``layer1_0/downsample_bn`` ->
  ``layer1.0.downsample.1``, ``features_1_bn`` -> ``features.1``,
  ``classifier_0`` -> ``classifier.0``), the inverse of the JAX package's
  ``convert.py:_nest_path``. The flax ``backbone`` scope becomes
  ``base_model``.
* :func:`jax_from_state_dict` is its inverse: the port's ``state_dict``
  as the JAX package's flax ``(params, batch_stats)`` trees, scoped as the
  JAX package's ``convert.py:_nest_path`` scopes a torch layer.
* :func:`quantized_from_jax` maps a JAX int8-e2e tree
  (``quantize_backbone_e2e`` or ``calibrate_e2e_iv3``) onto the port's int8
  runtime tensors, so a test can hold the int8 runtime apart from
  calibration.
* :func:`seeded_init` gives a model reproducible random weights with jittered
  BN statistics (so quantization is not trivial) from a numpy seed.
* :func:`backbone_state_from_reference` reads a reference backbone state
  dict (``.pth``; ``module.``/``base_model.`` prefixes stripped: the port's
  module names are the reference's) and :func:`cross_modality_init` makes
  an RGB first conv a Flow one (the JAX package's ``convert.py``).
* :func:`ssn_state_from_reference` reads a whole reference SSN or binary
  checkpoint (the JAX package's ``convert_torch_ssn_checkpoint``).

Everything here is numpy -> torch; nothing imports jax.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

_SCOPES = {"backbone": "base_model"}
# flax layer name -> the port's module path: InceptionV3's
# <Conv2d_*|branch*>_conv and _bn -> <x>.conv, <x>.bn; ResNet's downsample
# pair; VGG's torchvision indices (its BN scopes carry a _bn suffix)
_LAYERS = ((re.compile(r"^(Conv2d_\w+|branch\w*)_(conv|bn)$"), r"\1.\2"),
           (re.compile(r"^downsample_conv$"), "downsample.0"),
           (re.compile(r"^downsample_bn$"), "downsample.1"),
           (re.compile(r"^features_(\d+)(_bn)?$"), r"features.\1"),
           (re.compile(r"^classifier_(\d+)$"), r"classifier.\1"))
# ResNet's block scopes: layer1_0 -> layer1.0
_RESNET_BLOCK = re.compile(r"^layer(\d+)_(\d+)$")


def _host(a) -> np.ndarray:
    """A leaf as numpy (a bfloat16 tensor of the msgpack reader widens to
    float32 exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a)


def _walk(tree: dict, prefix: str, out: Dict[str, np.ndarray],
          stats: bool) -> None:
    for name, node in tree.items():
        if not isinstance(node, dict):
            continue
        leaf_keys = set(node)
        for pattern, repl in _LAYERS:
            name = pattern.sub(repl, name)
        if stats and {"mean", "var"} <= leaf_keys:
            out[f"{prefix}{name}.running_mean"] = _host(node["mean"])
            out[f"{prefix}{name}.running_var"] = _host(node["var"])
        elif not stats and "kernel" in leaf_keys:
            k = _host(node["kernel"])
            w = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
            out[f"{prefix}{name}.weight"] = w
            if "bias" in node:
                out[f"{prefix}{name}.bias"] = _host(node["bias"])
        elif not stats and "scale" in leaf_keys:
            out[f"{prefix}{name}.weight"] = _host(node["scale"])
            out[f"{prefix}{name}.bias"] = _host(node["bias"])
        else:
            # a module scope: inception_3a/inception_3a_1x1 -> the flat
            # blob name; InceptionV3's Mixed_* scopes stay; ResNet's
            # layer1_0 -> layer1.0; the top-level backbone scope ->
            # base_model
            block = _RESNET_BLOCK.match(name)
            scope = (name if name.startswith("Mixed_")
                     else f"layer{block.group(1)}.{block.group(2)}" if block
                     else _SCOPES.get(name) if not prefix else None)
            _walk(node, prefix + scope + "." if scope else prefix, out, stats)


def state_dict_from_jax(params: dict, batch_stats: dict = None
                        ) -> Dict[str, torch.Tensor]:
    """Flax SSN (or bare backbone) trees -> the port's ``state_dict``."""
    flat: Dict[str, np.ndarray] = {}
    _walk(params, "", flat, stats=False)
    _walk(batch_stats or {}, "", flat, stats=True)
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in flat.items()}
    for k in list(sd):
        if k.endswith(".running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return sd


def _flax_scope(layer: str, arch: str, is_bn: bool) -> tuple:
    """The flax scope of a backbone layer (its torch module path), as the
    JAX package's ``convert.py:_nest_path`` gives it: BNInception's
    ``inception_3a_1x1`` under ``inception_3a``; InceptionV3's
    ``Mixed_5b.branch1x1.conv`` -> ``(Mixed_5b, branch1x1_conv)``; ResNet's
    ``layer1.0.downsample.1`` -> ``(layer1_0, downsample_bn)``; VGG's
    ``features.N`` -> ``features_N`` (``features_N_bn`` for a BN) and
    ``classifier.N`` -> ``classifier_N``; any other name as it is."""
    if arch == "BNInception" and layer.startswith("inception_"):
        return ("_".join(layer.split("_")[:2]), layer)
    parts = layer.split(".")
    if arch == "InceptionV3" and len(parts) > 1:
        if parts[-1] in ("conv", "bn"):
            parts = parts[:-2] + [f"{parts[-2]}_{parts[-1]}"]
        return tuple(parts)
    if arch.startswith("vgg") and len(parts) == 2:
        return (f"{parts[0]}_{parts[1]}"
                + ("_bn" if is_bn and parts[0] == "features" else ""),)
    if arch.startswith("resnet") and len(parts) > 1:
        out, i = [], 0
        while i < len(parts):
            p = parts[i]
            if p.startswith("layer") and i + 1 < len(parts) \
                    and parts[i + 1].isdigit():
                out.append(f"{p}_{parts[i + 1]}")
                i += 2
            elif p == "downsample" and i + 1 < len(parts):
                out.append("downsample_conv" if parts[i + 1] == "0"
                           else "downsample_bn")
                i += 2
            else:
                out.append(p)
                i += 1
        return tuple(out)
    return (layer,)


def jax_from_state_dict(state_dict: Dict[str, Any], arch: str
                        ) -> tuple:
    """The port's SSN, binary or bare-backbone ``state_dict`` -> the JAX
    package's flax ``(params, batch_stats)`` trees (float32 numpy, a
    bfloat16 tensor widened exactly), the inverse of
    :func:`state_dict_from_jax`: ``base_model.*`` under ``backbone`` (a
    key without that prefix and outside the heads is a bare backbone's),
    each layer under :func:`_flax_scope` of ``arch``; conv ``weight (O, I,
    H, W)`` -> ``kernel (H, W, I, O)``, linear ``weight (O, I)`` ->
    ``kernel (I, O)``, BN ``weight``/``bias`` -> ``scale``/``bias`` in
    ``params`` and ``running_mean``/``running_var`` -> ``mean``/``var`` in
    ``batch_stats``; ``num_batches_tracked`` is dropped (flax keeps no
    such count)."""
    layers: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in state_dict.items():
        layer, _, leaf = key.rpartition(".")
        if leaf != "num_batches_tracked":
            layers.setdefault(layer, {})[leaf] = _host(v).astype(np.float32)
    params: dict = {}
    stats: dict = {}

    def put(tree, path, leaf, value):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value

    for layer, leaves in layers.items():
        head = layer.split(".")[0]
        is_bn = "running_mean" in leaves
        if head in HEADS and "." not in layer:
            path = (layer,)
        else:
            name = layer[len("base_model."):] if layer.startswith(
                "base_model.") else layer
            path = ("backbone",) * layer.startswith("base_model.") + \
                _flax_scope(name, arch, is_bn)
        for leaf, a in leaves.items():
            if leaf == "weight" and is_bn:
                put(params, path, "scale", a)
            elif leaf == "weight":
                put(params, path, "kernel", a.transpose(2, 3, 1, 0)
                    if a.ndim == 4 else a.T)
            elif leaf == "bias":
                put(params, path, "bias", a)
            elif leaf == "running_mean":
                put(stats, path, "mean", a)
            elif leaf == "running_var":
                put(stats, path, "var", a)
            else:
                raise ValueError(f"{layer}.{leaf}: a state dict entry with "
                                 "no flax counterpart")
    return params, stats


def quantized_from_jax(qe: Dict[str, Any]) -> Dict[str, Any]:
    """JAX int8-e2e tree (BNInception's or InceptionV3's; conv entries keyed
    by layer name, ``__stem__``, ``__entry__`` and scalar scales) -> the
    port's runtime tensors."""
    from .backbones.bn_inception_int8 import tensor_tree

    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        a = np.asarray(node)
        # bf16 (the hybrid stem) widens exactly to f32; tensor_tree narrows
        # it back to torch's bf16
        return a if a.dtype in (np.int8, np.float32) else a.astype(np.float32)

    return tensor_tree(host(qe))


def seeded_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """Reproducible random weights from ``np.random.RandomState(seed)``.

    Convs get He-normal kernels and zero biases (if they have one), BN
    layers jittered affine
    parameters and running statistics (the JAX int8 tests' fixture ranges:
    scale 1+0.1N, bias 0.05N, mean 0.05N, var 1+0.3U), linear heads
    N(0, 0.001) kernels and zero biases, as the JAX SSN initializes them;
    a backbone's FC layers (VGG's ``classifier.0`` and ``.3``) He-normal
    kernels and zero biases, as its convs.
    """
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(t(rng.randn(*m.weight.shape)
                                 * np.sqrt(2.0 / fan_in)))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(t(1.0 + 0.1 * rng.randn(n)))
                m.bias.copy_(t(0.05 * rng.randn(n)))
                m.running_mean.copy_(t(0.05 * rng.randn(n)))
                m.running_var.copy_(t(1.0 + 0.3 * rng.rand(n)))
            elif isinstance(m, nn.Linear) and name.split(".")[-2:-1] == [
                    "classifier"]:
                # a backbone's own FC layer (VGG's fc6, fc7), as a conv
                m.weight.copy_(t(rng.randn(*m.weight.shape)
                                 * np.sqrt(2.0 / m.in_features)))
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                m.weight.copy_(t(0.001 * rng.randn(*m.weight.shape)))
                m.bias.zero_()
    return model


def strip_prefix(state_dict: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """Remove e.g. the DataParallel ``module.`` prefix from every key."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state_dict.items()}


def backbone_state_from_reference(state_dict: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """A reference backbone state dict (tensors or numpy arrays, possibly
    under DataParallel's ``module.`` and SSN's ``base_model.``) -> tensors
    keyed by the port's backbone names. The module names already are the
    reference's, so this strips the two prefixes and nothing else."""
    sd = strip_prefix(strip_prefix(state_dict, "module."), "base_model.")
    return {k: _tensor(v) for k, v in sd.items()}


#: the linear heads of the SSN and binary models
HEADS = ("activity_fc", "completeness_fc", "regressor_fc", "classifier_fc")


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def ssn_state_from_reference(checkpoint: Dict[str, Any], arch: str = ""
                             ) -> Dict[str, Any]:
    """A whole reference SSN or binary checkpoint (its ``state_dict``
    possibly under DataParallel's ``module.``; ``reg_stats`` a tensor or a
    numpy array) -> the port's checkpoint dict ``{"state_dict",
    "reg_stats", "arch", "epoch", "best_loss"}``.

    Keeps the ``base_model.*`` weights and the heads (``activity_fc``,
    ``completeness_fc``, ``regressor_fc``, ``classifier_fc``), as the JAX
    package's ``convert_torch_ssn_checkpoint`` does; a BN that has no
    ``num_batches_tracked`` (a checkpoint of an older torch) gets a zero
    one. ``arch`` stands in where the checkpoint names none."""
    sd = strip_prefix(checkpoint["state_dict"], "module.")
    out = {k: _tensor(v) for k, v in sd.items()
           if k.startswith("base_model.") or k.split(".")[0] in HEADS}
    for k in list(out):
        if k.endswith(".running_mean"):
            out.setdefault(k[:-len("running_mean")] + "num_batches_tracked",
                           torch.tensor(0, dtype=torch.int64))
    rs = checkpoint.get("reg_stats")
    return {"state_dict": out,
            "reg_stats": None if rs is None else _tensor(rs).numpy(),
            "arch": checkpoint.get("arch", arch),
            "epoch": int(checkpoint.get("epoch", 0)),
            "best_loss": float(checkpoint.get("best_loss", float("inf")))}


def cross_modality_init(weight: torch.Tensor,
                        in_channels: int) -> torch.Tensor:
    """A first-conv weight ``(O, I, H, W)`` -> ``(O, in_channels, H, W)``:
    its mean over the input channels, tiled (the reference's RGB -> Flow
    first conv; computed in numpy, as the JAX package's
    ``convert_first_conv_cross_modality`` does)."""
    w = weight.detach().cpu().numpy()
    mean = w.mean(axis=1, keepdims=True)
    return torch.from_numpy(np.broadcast_to(
        mean, (w.shape[0], in_channels) + w.shape[2:]).copy())
