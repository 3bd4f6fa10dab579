#!/usr/bin/env bash
# Full ActivityNet v1.2 reproduction recipe on the PyTorch port: the twin
# of scripts/reproduce_anet12.sh (batch 16, lr steps 3/6, 7 epochs,
# Kinetics init optional), the same steps with the same flags, each
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
#      release), or generate your own via the TAG pipeline in
#      reproduce_thumos14.sh step 1.
#   3. (optional) Kinetics-pretrained initializations — resolved by
#      --kinetics_pretrain from the dataset config's kinetics_pretrain URL
#      map against the local cache ($ADT_MODEL_CACHE) and converted on
#      load (models/convert.py). Set KINETICS=1 to enable below.
set -euo pipefail

REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

FRAME_PATH=${1:?usage: reproduce_anet12.sh FRAME_PATH [WORKDIR]}
WORK=${2:-work_anet12}
mkdir -p "$WORK"

# ---- 0. adapt normalized proposal lists to the local frame extraction ----
python -m action_detection_torch.cli.gen_proposal_list activitynet1.2 \
    "$FRAME_PATH"

# ---- 1. train both streams (reference recipe: b=16, lr steps 3/6, 7 ep) ----
# (checkpoint names follow the reference scheme
#  ssn<pref>_<dataset>_<arch>_<modality>_checkpoint.pt, landing in cwd)
python -m action_detection_torch.cli.ssn_train activitynet1.2 RGB -b 16 \
    --lr 0.001 --lr_steps 3 6 --epochs 7 --data_root "$FRAME_PATH" \
    ${KINETICS:+--kinetics_pretrain}
python -m action_detection_torch.cli.ssn_train activitynet1.2 Flow -b 16 \
    --lr 0.005 --lr_steps 3 6 --epochs 7 --data_root "$FRAME_PATH" \
    ${KINETICS:+--kinetics_pretrain}

# ---- 2. score the validation set (10-crop dense scoring) ----
python -m action_detection_torch.cli.ssn_test activitynet1.2 RGB \
    ssn_activitynet1.2_BNInception_rgb_checkpoint.pt \
    "$WORK/scores_rgb.pkl" --data_root "$FRAME_PATH"
python -m action_detection_torch.cli.ssn_test activitynet1.2 Flow \
    ssn_activitynet1.2_BNInception_flow_checkpoint.pt \
    "$WORK/scores_flow.pkl" --data_root "$FRAME_PATH"

# ---- 3. two-stream fusion + average mAP over IoU 0.5:0.05:0.95 ----
# (ANet eval uses top_k=60, NMS=0.6 from the dataset config)
python -m action_detection_torch.cli.eval_detection_results activitynet1.2 \
    "$WORK/scores_rgb.pkl" "$WORK/scores_flow.pkl" --score_weights 1 2
