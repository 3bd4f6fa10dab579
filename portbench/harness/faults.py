"""Faults planted under the scoring job's timed path, for the readings that
a limit is set from (``readings.py --fault``) and for the tests that see
``correct`` come out false. Each takes ``patch(owner, name, value)``
(``setattr``, or pytest's ``monkeypatch.setattr``) and replaces one method
of the port's scorer with a broken one."""

from __future__ import annotations

import torch


def half_crops(patch) -> None:
    """Half of the 10 crops left out: each tick's features are the mean
    over its first 5 crops (the crop-major rows of crops 5-9 repeat those
    of crops 0-4)."""
    from action_detection_torch.infer.scorer import ProposalScorer

    features = ProposalScorer._crop_features

    def half(self, frames_u8):
        out = features(self, frames_u8)
        keep = out.shape[0] // 2
        return torch.cat([out[:keep], out[:keep]])

    patch(ProposalScorer, "_crop_features", half)


def half_ticks(patch) -> None:
    """Half of each chunk's ticks left out of the device step; their rows
    take the mean of the rows scored."""
    from action_detection_torch.infer.scorer import ProposalScorer

    score = ProposalScorer._score_chunk

    def half(self, frames_u8, n_stacks):
        out = score(self, frames_u8, n_stacks)
        keep = max(1, out.shape[0] // 2)
        return torch.cat([out[:keep], out[:keep].mean(0, keepdim=True)
                          .expand(out.shape[0] - keep, -1)])

    patch(ProposalScorer, "_score_chunk", half)


def altered_answer(patch) -> None:
    """The completeness scores of the video whose length is the mix's
    second come back for its proposals in the reverse order."""
    from action_detection_torch.infer.scorer import ProposalScorer

    pool = ProposalScorer._pool_video

    def altered(self, sample, *a, **k):
        out = pool(self, sample, *a, **k)
        if sample.video_id.endswith("_01"):
            out.comp_scores = out.comp_scores[::-1].copy()
        return out

    patch(ProposalScorer, "_pool_video", altered)


FAULTS = {"half_crops": half_crops, "half_ticks": half_ticks,
          "altered_answer": altered_answer}
