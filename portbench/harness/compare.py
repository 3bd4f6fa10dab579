"""The comparison that decides ``correct`` for scoring: the scores the timed
path returned against the plain reference's (``portbench/reference``),
from the same proposal list, frames and weights.

The reference runs the backbone at the precisions the configuration
states (its ``stated`` network: for BN-Inception the bf16 stem and the
int8 trunk, calibrated anew from the weights and the calibration frames),
or, for a configuration without one, in float32. The number compared is
a video's widest relative gap: for each of its three outputs (activity,
completeness, regression), the norm of the program's difference from the
reference over the norm of the reference's frame-dependent part, and the
largest of the three over the sampled videos. The frame-dependent part is
the reference's output less that of a frame-blind scorer, one that gives
every tick the mean feature of the 8 fixture frames: so a program that
ignored its frames reads about 1, and the biases, the regression offset
and the features' common part, which every frame shares, do not dilute
the gap. The frames repeat the 8 fixture frames, so the reference runs
its backbone once a fixture and scores every tick from those features.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from ..reference.quant import IDENTITY, FakeQuant
from ..reference.ssn import (FloatNet, calibration_frames, frame_features,
                             oversample, read_proposal_list, score_video,
                             test_plan)
from .traffic import fixture_pixels

HEADS = ("activity_fc", "completeness_fc", "regressor_fc")


def control_quantizer(config: dict) -> FakeQuant:
    """A float reference's control: ``control_bits`` of the configuration,
    its stem convs (the ``stem`` rows of the layer table) at ``stem`` bits
    and every other conv at ``trunk`` bits."""
    bits = config["control_bits"]
    stem = {name for r in config["score_layers"]
            if r["per"] == "stem" and r["op"] == "conv"
            for name in r["name"].split("+")}
    return FakeQuant(bits["trunk"], {n: bits["stem"] for n in stem})


def reference_net(job, control: bool = False):
    """The job's backbone in the reference: the configuration's ``stated``
    network, calibrated on the calibration frames of the job's proposal
    list (with ``control``, at the ``control`` precisions), or the float32
    one (with ``control``, through :func:`control_quantizer`)."""
    config, device = job.config, job.device
    backbone = {k[len("base_model."):]: v.to(device, torch.float32)
                for k, v in job.weights.items()
                if k.startswith("base_model.")}
    stated = config.get("stated")
    if stated is None:
        return FloatNet(config["reference"], backbone,
                        control_quantizer(config) if control else IDENTITY)
    seq_of = {v.vid: job.traffic.sequences[v.sequence]
              for v in job.traffic.videos + [job.traffic.warmup]}
    picks = calibration_frames(read_proposal_list(job.proposal_list),
                               config["frame_interval"],
                               stated["calibration_videos"])
    crops = oversample(fixture_pixels()[[seq_of[v][t] for v, t in picks]],
                       config["input"], device)
    kind = dict(stated, **config["control"]) if control else stated
    module = importlib.import_module("..reference." + stated["module"],
                                     __package__)
    return module.Network(backbone, crops, kind["levels"], kind["stem"])


def reference_scores(job, vids: List[str], net) -> Dict[str, tuple]:
    """``{video: ((act, comp, reg), (act0, comp0, reg0))}`` of the
    reference with the backbone ``net`` on the job's device (TF32 off):
    its scores and the frame-blind scores (every tick the fixtures' mean
    feature)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic, device = job.config, job.traffic, job.device
    plan = read_proposal_list(job.proposal_list)
    seq_of = {v.vid: traffic.sequences[v.sequence]
              for v in traffic.videos + [traffic.warmup]}
    plans = {}
    for vid in vids:
        frames, props = plan[vid]
        ticks, bounds, scaling = test_plan(frames, props,
                                           config["frame_interval"])
        plans[vid] = (seq_of[vid][ticks], bounds, scaling)
    heads = {k: v.to(device, torch.float32) for k, v in job.weights.items()
             if k.split(".")[0] in HEADS}
    feats = frame_features(net, fixture_pixels(), config["input"], device,
                           config["chunk_ticks"])
    blind = feats.mean(dim=0, keepdim=True)
    out = {}
    with torch.no_grad():
        for vid, (fixtures, bounds, scaling) in plans.items():
            f = feats[torch.as_tensor(fixtures, device=device)]
            out[vid] = (score_video(f, bounds, scaling, heads,
                                    job.reg_stats),
                        score_video(blind.expand_as(f), bounds, scaling,
                                    heads, job.reg_stats))
    return out


def relative_gap(got, ref, blind) -> float:
    """The widest of the three outputs' ``|got - ref| / |ref - blind|``."""
    worst = 0.0
    for g, r, z in zip(got, ref, blind):
        g = torch.as_tensor(np.asarray(g), dtype=torch.float64)
        r, z = r.double().cpu(), z.double().cpu()
        if g.shape != r.shape:
            return float("inf")
        num = torch.linalg.vector_norm(g - r).item()
        den = torch.linalg.vector_norm(r - z).item()
        gap = num / den if den > 0 else (0.0 if num == 0 else float("inf"))
        worst = max(worst, gap if np.isfinite(gap) else float("inf"))
    return worst


def sample_videos(scored: list, traffic, sample: int, seed: int) -> list:
    """Up to ``sample`` of the ``(call, video)`` pairs, drawn from the
    seed, with one of the longest videos among them."""
    if len(scored) <= sample:
        return scored
    frames = {v.vid: v.frames for v in traffic.videos}
    longest = max(scored, key=lambda cv: frames[cv[1]])
    rng = np.random.default_rng([seed, 11])
    picked = [scored[i] for i in rng.choice(len(scored), sample - 1,
                                            replace=False)]
    return picked if longest in picked else picked + [longest]


def compare_scores(job, run, scored: list, sample: int) -> float:
    """The widest relative gap over a seeded sample of the ``(call,
    video)`` pairs scored in the window."""
    picked = sample_videos(scored, job.traffic, sample, job.seed)
    vids = sorted({v for _, v in picked})
    ref = reference_scores(job, vids, reference_net(job))
    worst = 0.0
    for call, vid in picked:
        got = run.calls[call].results[vid]
        r, z = ref[vid]
        worst = max(worst, relative_gap(
            (got.act_scores, got.comp_scores, got.reg_scores), r, z))
    return worst


def control_gap(job, vids: List[str]) -> float:
    """The control's reading: the reference at the configuration's
    control precisions put in the program's place, its widest relative
    gap from the reference over the videos ``vids``."""
    ref = reference_scores(job, vids, reference_net(job))
    ctl = reference_scores(job, vids, reference_net(job, control=True))
    return max(relative_gap([t.cpu().numpy() for t in ctl[v][0]], *ref[v])
               for v in vids)
