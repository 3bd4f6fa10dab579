"""The weight bridge from the JAX package, and a seeded random init.

* :func:`state_dict_from_jax` maps flax ``params``/``batch_stats`` trees
  (given as numpy) onto the port's ``state_dict``: conv ``kernel (H, W, I,
  O)`` -> ``weight (O, I, H, W)``, Dense ``kernel (I, O)`` -> ``weight (O,
  I)``, BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
  running_var``. Module scopes collapse to the flat Caffe blob names
  (BNInception); InceptionV3's tf-slim names keep their module path, flax
  ``Mixed_5b/branch1x1_conv`` becoming ``Mixed_5b.branch1x1.conv``. The
  flax ``backbone`` scope becomes ``base_model``.
* :func:`quantized_from_jax` maps a JAX int8-e2e tree
  (``quantize_backbone_e2e`` or ``calibrate_e2e_iv3``) onto the port's int8
  runtime tensors, so a test can hold the int8 runtime apart from
  calibration.
* :func:`seeded_init` gives a model reproducible random weights with jittered
  BN statistics (so quantization is not trivial) from a numpy seed.

Everything here is numpy -> torch; nothing imports jax.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

_SCOPES = {"backbone": "base_model"}
# InceptionV3's layers: <Conv2d_*|branch*>_conv and _bn -> <x>.conv, <x>.bn
_IV3_LAYER = re.compile(r"^(Conv2d_\w+|branch\w*)_(conv|bn)$")


def _walk(tree: dict, prefix: str, out: Dict[str, np.ndarray],
          stats: bool) -> None:
    for name, node in tree.items():
        if not isinstance(node, dict):
            continue
        leaf_keys = set(node)
        iv3 = _IV3_LAYER.match(name)
        if iv3:
            name = f"{iv3.group(1)}.{iv3.group(2)}"
        if stats and {"mean", "var"} <= leaf_keys:
            out[f"{prefix}{name}.running_mean"] = np.asarray(node["mean"])
            out[f"{prefix}{name}.running_var"] = np.asarray(node["var"])
        elif not stats and "kernel" in leaf_keys:
            k = np.asarray(node["kernel"])
            w = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
            out[f"{prefix}{name}.weight"] = w
            if "bias" in node:
                out[f"{prefix}{name}.bias"] = np.asarray(node["bias"])
        elif not stats and "scale" in leaf_keys:
            out[f"{prefix}{name}.weight"] = np.asarray(node["scale"])
            out[f"{prefix}{name}.bias"] = np.asarray(node["bias"])
        else:
            # a module scope: inception_3a/inception_3a_1x1 -> the flat
            # blob name; InceptionV3's Mixed_* scopes stay; the top-level
            # backbone scope -> base_model
            scope = (name if name.startswith("Mixed_")
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
    N(0, 0.001) kernels and zero biases, as the JAX SSN initializes them.
    """
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    with torch.no_grad():
        for m in model.modules():
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
            elif isinstance(m, nn.Linear):
                m.weight.copy_(t(0.001 * rng.randn(*m.weight.shape)))
                m.bias.zero_()
    return model
