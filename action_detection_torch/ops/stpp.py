"""Structured Temporal Pyramid Pooling (torch).

Port of ``action_detection_tpu/ops/stpp.py``. Training pools each
proposal's sampled segment features with one static (segments x parts)
matrix (:func:`stpp_train_pool`). Scoring pools per-frame scores: one
exclusive cumulative sum over frames turns every part mean into two gathers
and a subtraction, ``mean = (cs[pr] - cs[pl]) / (pr - pl)``.

The part bounds ride the reference's float64 ``np.arange`` pipeline on the
host (:func:`reference_part_bounds`, copied as is): no in-graph formula
reproduces its accumulation quirk, and proposal ticks are host data anyway.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import numpy as np
import torch

StageSpec = Union[int, Tuple[int, ...]]


def parse_stage_config(stage_cfg: StageSpec) -> Tuple[Tuple[int, ...], int]:
    """Normalize a stage spec to (parts tuple, total part count)."""
    if isinstance(stage_cfg, int):
        return (stage_cfg,), stage_cfg
    if isinstance(stage_cfg, (tuple, list)):
        return tuple(stage_cfg), sum(stage_cfg)
    raise ValueError(f"Incorrect STPP config {stage_cfg}")


@dataclasses.dataclass(frozen=True)
class StppConfig:
    """Static pyramid structure: pyramid level sizes for the 3 stages."""
    starting_parts: Tuple[int, ...]
    course_parts: Tuple[int, ...]
    ending_parts: Tuple[int, ...]

    @classmethod
    def from_raw(cls, cfg: Sequence[StageSpec]) -> "StppConfig":
        s, _ = parse_stage_config(cfg[0])
        c, _ = parse_stage_config(cfg[1])
        e, _ = parse_stage_config(cfg[2])
        return cls(s, c, e)

    @property
    def stage_parts(self) -> Tuple[Tuple[int, ...], ...]:
        return (self.starting_parts, self.course_parts, self.ending_parts)

    @property
    def stage_multipliers(self) -> Tuple[int, int, int]:
        return (sum(self.starting_parts), sum(self.course_parts),
                sum(self.ending_parts))

    @property
    def feat_multiplier(self) -> int:
        return sum(self.stage_multipliers)

    def part_table(self):
        """Per-part static metadata: (stage_idx, level_size, index_in_level),
        in the reference's concatenation order."""
        table = []
        for stage_idx, parts in enumerate(self.stage_parts):
            for n_part in parts:
                for i in range(n_part):
                    table.append((stage_idx, n_part, i))
        return table


def stpp_pool_matrix(seg_split: Tuple[int, int, int], cfg: StppConfig
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The static (num_segments, num_parts) training pooling matrix.

    ``seg_split = (x1, x2, n_seg)``: segments [0,x1) are the starting stage,
    [x1,x2) the course stage, [x2,n_seg) the ending stage. Entry ``W[s, j]``
    is ``1 / (len(part_j) * norm_num(stage of j))`` when segment ``s`` falls
    in part ``j``. Also returns ``stage_id`` (num_parts,) in {0,1,2}, which
    selects the start/end validity scaling of each part.
    """
    x1, x2, n_seg = seg_split
    stage_bounds = [(0, x1), (x1, x2), (x2, n_seg)]
    mults = cfg.stage_multipliers
    cols, stage_ids = [], []
    for stage_idx, parts in enumerate(cfg.stage_parts):
        lo, hi = stage_bounds[stage_idx]
        stage_len = hi - lo
        for n_part in parts:
            # part boundaries replicate arange(0, L+eps, L/n) + int()
            ticks = [int(stage_len * i / n_part) for i in range(n_part + 1)]
            ticks[-1] = stage_len
            for i in range(n_part):
                col = np.zeros(n_seg, dtype=np.float32)
                lo_i, hi_i = lo + ticks[i], lo + ticks[i + 1]
                if hi_i > lo_i:
                    col[lo_i:hi_i] = 1.0 / ((hi_i - lo_i) * mults[stage_idx])
                cols.append(col)
                stage_ids.append(stage_idx)
    return np.stack(cols, axis=1), np.asarray(stage_ids, dtype=np.int64)


def stpp_train_pool(ft: torch.Tensor, scaling: torch.Tensor,
                    seg_split: Tuple[int, int, int], cfg: StppConfig,
                    standalone_classifier: bool = True):
    """Training-time STPP of ``(P, S, D)`` segment features.

    ``scaling`` (P, 2) holds the start/end stage validity scalings. Returns
    ``(activity_ft, completeness_ft)``: the plain course-stage mean (P, D)
    when ``standalone_classifier`` (SSN's setting), else the pyramid, and
    the pyramid (P, J*D) in part-major order.
    """
    W_np, stage_ids = stpp_pool_matrix(seg_split, cfg)
    W = torch.from_numpy(W_np).to(device=ft.device, dtype=ft.dtype)
    pooled = torch.einsum("psd,sj->pjd", ft, W)
    scale_sel = torch.stack([scaling[:, 0], torch.ones_like(scaling[:, 0]),
                             scaling[:, 1]], dim=1)                # (P, 3)
    part_scale = scale_sel[:, torch.from_numpy(stage_ids).to(ft.device)]
    pooled = pooled * part_scale[:, :, None].to(pooled.dtype)
    P, J, D = pooled.shape
    stpp_ft = pooled.reshape(P, J * D)
    if standalone_classifier:
        x1, x2, _ = seg_split
        return ft[:, x1:x2, :].mean(dim=1), stpp_ft
    return stpp_ft, stpp_ft


@dataclasses.dataclass(frozen=True)
class ReorganizedScoreLayout:
    """Column layout of the fused test-FC output (act | comp parts | reg parts)."""
    act_len: int
    comp_len: int
    reg_len: int
    feat_multiplier: int
    standalone_classifier: bool = True
    with_regression: bool = True

    @property
    def act_cols(self) -> int:
        return (self.act_len if self.standalone_classifier
                else self.act_len * self.feat_multiplier)

    @property
    def total_cols(self) -> int:
        cols = self.act_cols + self.comp_len * self.feat_multiplier
        if self.with_regression:
            cols += self.reg_len * self.feat_multiplier
        return cols


def reorganized_score_slices(layout: ReorganizedScoreLayout):
    """(act, comp, reg) column slices of the fused score matrix."""
    act = slice(0, layout.act_cols)
    comp = slice(act.stop, act.stop + layout.comp_len * layout.feat_multiplier)
    reg = slice(comp.stop, comp.stop + layout.reg_len * layout.feat_multiplier) \
        if layout.with_regression else None
    return act, comp, reg


def reference_part_bounds(prop_ticks: np.ndarray, cfg: StppConfig):
    """Host-side per-(proposal, part) [pl, pr) bounds, bit-exact vs reference.

    The reference computes part boundaries as
    ``int(np.arange(left, right + 1e-5, (right - left) / n_part)[k])``.
    ``np.arange`` fills by *accumulating* the float64 step with per-element
    rounding, so e.g. span 7 / 3 parts ends at 23.999999999999996 -> int 23
    (NOT the rational 24). No closed-form formula reproduces this, so the
    literal float64 pipeline runs here on host. Returns (pl, pr) int32
    arrays of shape (P, J).
    """
    ticks = np.asarray(prop_ticks)
    table = cfg.part_table()
    P, J = ticks.shape[0], len(table)
    pl = np.zeros((P, J), np.int32)
    pr = np.zeros((P, J), np.int32)
    memo = {}
    for j, (s, n_part, k) in enumerate(table):
        for p in range(P):
            left = int(ticks[p, s])
            right = max(left + 1, int(ticks[p, s + 1]))
            key = (left, right, n_part)
            bounds = memo.get(key)
            if bounds is None:
                part_ticks = np.arange(left, right + 1e-5,
                                       (right - left) / n_part)
                bounds = memo[key] = [int(x) for x in part_ticks]
            pl[p, j] = bounds[k]
            pr[p, j] = bounds[k + 1]
    return pl, pr


def _excl_cumsum(block: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros((1,) + tuple(block.shape[1:]), dtype=block.dtype,
                        device=block.device)
    return torch.cat([zeros, torch.cumsum(block, dim=0)], dim=0)


def _pool_block(cs: torch.Tensor, pl: torch.Tensor, pr: torch.Tensor,
                valid: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Sum over parts of scaled part means from an exclusive cumsum.

    cs: ``(T+1, J, C)``; pl/pr/valid/scale: ``(P, J)``. Returns ``(P, C)``.
    """
    T = cs.shape[0] - 1
    pl_c = pl.clamp(0, T)
    pr_c = pr.clamp(0, T)
    j_idx = torch.arange(cs.shape[1], device=cs.device)[None, :]
    upper = cs[pr_c, j_idx]                                    # (P, J, C)
    lower = cs[pl_c, j_idx]
    denom = torch.clamp_min(pr_c - pl_c, 1).to(cs.dtype)
    means = (upper - lower) / denom[:, :, None]
    weights = torch.where(valid, scale, torch.zeros_like(scale)).to(cs.dtype)
    return torch.einsum("pjc,pj->pc", means, weights)


def reorganized_stpp_pool(scores: torch.Tensor, prop_ticks: np.ndarray,
                          prop_scaling: np.ndarray,
                          layout: ReorganizedScoreLayout, cfg: StppConfig,
                          num_frames: int = None, part_bounds=None):
    """Pool per-frame fused scores into per-proposal (act, comp, reg) scores.

    Args:
      scores: ``(T, total_cols)`` per-frame fused test-FC outputs (float32,
        any device). Rows at or beyond ``num_frames`` may be padding.
      prop_ticks: ``(P, 4)`` int host ticks (start-aug, start, end, end-aug)
        in subsampled-frame coordinates.
      prop_scaling: ``(P, 2)`` host start/end validity scalings.
      num_frames: real (unpadded) number of scored frames; defaults to ``T``.
      part_bounds: optional host ``(pl, pr)`` from
        :func:`reference_part_bounds`; computed here when None.

    Returns ``(act (P, act_len), comp (P, comp_len), reg (P, reg_len) or
    None)`` on ``scores.device``.
    """
    T = scores.shape[0]
    if num_frames is None:
        num_frames = T
    dev = scores.device
    ticks_np = np.asarray(prop_ticks)
    if part_bounds is None:
        part_bounds = reference_part_bounds(ticks_np, cfg)
    act_slice, comp_slice, reg_slice = reorganized_score_slices(layout)
    J = layout.feat_multiplier

    ticks = torch.as_tensor(ticks_np, dtype=torch.int64, device=dev)
    pl = torch.as_tensor(part_bounds[0], dtype=torch.int64, device=dev)
    pr = torch.as_tensor(part_bounds[1], dtype=torch.int64, device=dev)
    scaling = torch.as_tensor(np.asarray(prop_scaling), dtype=scores.dtype,
                              device=dev)

    # stage skip rule (right<=0 or left>=num_frames) and the per-part
    # pr-pl>=1 rule
    table = cfg.part_table()
    stage_idx = torch.as_tensor([t[0] for t in table], dtype=torch.int64,
                                device=dev)
    left = ticks[:, stage_idx]
    right = torch.maximum(left + 1, ticks[:, stage_idx + 1])
    valid = (right > 0) & (left < num_frames) & ((pr - pl) >= 1)
    scale_sel = torch.stack([scaling[:, 0], torch.ones_like(scaling[:, 0]),
                             scaling[:, 1]], dim=1)             # (P, 3)
    part_scale = scale_sel[:, stage_idx]                        # (P, J)

    if layout.standalone_classifier:
        cs_act = _excl_cumsum(scores[:, act_slice])             # (T+1, C)
        l = ticks[:, 1].clamp(0, num_frames)
        r = torch.maximum(ticks[:, 1] + 1, ticks[:, 2]).clamp(0, num_frames)
        denom = torch.clamp_min(r - l, 1).to(scores.dtype)
        act = (cs_act[r] - cs_act[l]) / denom[:, None]
    else:
        act_raw = scores[:, act_slice].reshape(T, J, layout.act_len)
        act = _pool_block(_excl_cumsum(act_raw), pl, pr, valid, part_scale)

    comp_raw = scores[:, comp_slice].reshape(T, J, layout.comp_len)
    comp = _pool_block(_excl_cumsum(comp_raw), pl, pr, valid, part_scale)

    reg = None
    if layout.with_regression:
        reg_raw = scores[:, reg_slice].reshape(T, J, layout.reg_len)
        reg = _pool_block(_excl_cumsum(reg_raw), pl, pr, valid, part_scale)
    return act, comp, reg
