#!/usr/bin/env bash
# Full THUMOS14 reproduction recipe on the PyTorch port: the twin of
# scripts/reproduce_thumos14.sh, the same steps with the same flags, each
# through `python -m action_detection_torch.cli.<cli>` on the GPU (the
# CLIs' default device). It runs from any working directory: the proposal
# lists (data/), the checkpoints and WORKDIR are relative to it.
#
# Prerequisites (as for the JAX script):
#   1. Extract frames + optical flow with denseflow (TSN tooling) into
#      $FRAME_PATH/<video>/{img,flow_x,flow_y}_00001.jpg ...
#      (JPEG, PNG, BMP or PNM files; the port's decoder reads them by
#      their bytes, as PIL does).
#   2. Download the normalized TAG proposal lists into data/ (reference
#      release), or generate your own via the TAG pipeline below.
#   3. (optional) a Flow init backbone as $FLOW_INIT (a reference .pth, a
#      port .pt or a JAX checkpoint.msgpack).
set -euo pipefail

REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

FRAME_PATH=${1:?usage: reproduce_thumos14.sh FRAME_PATH [WORKDIR]}
WORK=${2:-work_thumos14}
mkdir -p "$WORK"

# ---- 0. adapt normalized proposal lists to the local frame extraction ----
python -m action_detection_torch.cli.gen_proposal_list thumos14 "$FRAME_PATH"

# ---- 1. (alternative) generate TAG proposals from scratch ----
#   binary actionness model on the sliding-window lists, then grouping:
# python -m action_detection_torch.cli.binary_train thumos14 RGB -b 4 \
#     --epochs 3 --data_root "$FRAME_PATH"
# python -m action_detection_torch.cli.binary_test thumos14 RGB testing \
#     ssn_thumos14_BNInception_rgb_binary_checkpoint.pt \
#     "$WORK/actionness_rgb.pkl" --data_root "$FRAME_PATH"
#   ('validation' scores the train list instead, for TRAINING proposals)
# python -m action_detection_torch.cli.gen_bottom_up_proposals \
#     "$WORK/actionness_rgb.pkl" --dataset thumos14 \
#     --subset testing --frame_path "$FRAME_PATH" \
#     --write_proposals data/thumos14_tag_test_proposal_list.txt

# ---- 2. train both streams (reference recipe: b=16, lr steps 20/40, 45 ep) ----
# (checkpoint names follow the reference scheme
#  ssn<pref>_<dataset>_<arch>_<modality>_checkpoint.pt, landing in cwd)
python -m action_detection_torch.cli.ssn_train thumos14 RGB -b 16 \
    --lr 0.001 --lr_steps 20 40 --epochs 45 --data_root "$FRAME_PATH"
python -m action_detection_torch.cli.ssn_train thumos14 Flow -b 16 \
    --lr 0.005 --lr_steps 20 40 --epochs 45 --data_root "$FRAME_PATH" \
    --init_weights "${FLOW_INIT:-flow_init.pth}"  # cross-modality init is automatic

# ---- 3. score the test set (10-crop dense scoring; int8-e2e + shared-stem
#         is the default here — pass --no_int8 for bit-faithful float) ----
python -m action_detection_torch.cli.ssn_test thumos14 RGB \
    ssn_thumos14_BNInception_rgb_checkpoint.pt \
    "$WORK/scores_rgb.pkl" --data_root "$FRAME_PATH"
python -m action_detection_torch.cli.ssn_test thumos14 Flow \
    ssn_thumos14_BNInception_flow_checkpoint.pt \
    "$WORK/scores_flow.pkl" --data_root "$FRAME_PATH"

# ---- 4. two-stream fusion + mAP@tIoU (reference weights 1:2 RGB:Flow) ----
python -m action_detection_torch.cli.eval_detection_results thumos14 \
    "$WORK/scores_rgb.pkl" "$WORK/scores_flow.pkl" --score_weights 1 2
