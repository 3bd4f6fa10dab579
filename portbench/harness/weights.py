"""Seeded weights, made on the device in a few large draws.

The draws follow the port's and the JAX package's seeded checkpoints:
He-normal conv kernels with zero biases; BatchNorm scale ``1 + 0.1 N`` and
bias ``0.05 N``; the SSN heads ``N(0, 0.001)`` with zero biases. One
normal draw of the whole model's size, from one generator on the device,
is cut into the tensors in the state dict's order.

The BatchNorm running statistics are fitted instead (:func:`fit_batch_norm`):
the batch statistics of the fixture frames through the float32 reference,
layer by layer. A trained network's statistics match its data; with drawn
ones a random network's features barely depend on the frame (2-9% of
their norm on the fixtures; fitted: about 22%), and a check of the scores
could not tell one frame from another.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return "skip"
    if len(shape) == 4 and leaf == "weight":
        return "conv"
    if len(shape) == 2 and leaf == "weight":
        return "head"
    if leaf in ("running_mean", "running_var"):
        return "skip"           # fitted: fit_batch_norm
    owner = name.rsplit(".", 1)[0]
    return f"bn_{leaf}" if ("_bn" in owner or owner.endswith("bn")) \
        else "zero"


def seeded_state(shapes: Dict[str, tuple], seed: int, device) -> dict:
    """``{name: tensor}`` on ``device`` for every float entry of
    ``shapes`` (a state dict's names and shapes)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    total = sum(int(np.prod(s)) for s in shapes.values())
    normal = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        kind = _kind(name, shape)
        nrm = normal[at:at + n].view(shape)
        at += n
        if kind == "skip":
            continue
        if kind == "conv":
            t = nrm * float(np.sqrt(2.0 / np.prod(shape[1:])))
        elif kind == "head":
            t = nrm * 0.001
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * nrm
        elif kind == "bn_bias":
            t = 0.05 * nrm
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t
    return out


def fit_batch_norm(config: dict, weights: dict, device) -> None:
    """Sets each backbone BatchNorm's running mean and (biased) variance
    in ``weights`` to the statistics of its input batch when the float32
    reference (TF32 off) runs the 8 fixture frames through the shared-stem
    crops of the configuration."""
    from ..reference.ssn import FloatNet, frame_features
    from .traffic import fixture_pixels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prefix = "base_model."
    backbone = {k[len(prefix):]: v for k, v in weights.items()
                if k.startswith(prefix)}
    with torch.no_grad():
        frame_features(FloatNet(config["reference"], backbone),
                       fixture_pixels(), config["input"], device)
    for k, v in backbone.items():
        if k.endswith(("running_mean", "running_var")):
            weights[prefix + k] = v


def seeded_reg_stats(seed: int) -> np.ndarray:
    """``[[loc mean, dur mean], [loc std, dur std]]``: the regression
    targets' statistics a trained checkpoint carries."""
    rng = np.random.default_rng([seed, 7])
    return np.stack([rng.normal(0.0, 0.05, 2),
                     rng.uniform(0.1, 0.3, 2)]).astype(np.float32)
