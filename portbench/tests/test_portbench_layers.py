"""Each configuration's layer table is what the plain reference runs at the
configuration's sizes, with the port's parameter shapes."""

import json
import os

import pytest

from conftest import ROOT
from portbench.harness import layers
from portbench.reference.ssn import ARCHS


@pytest.mark.parametrize("name", ["ssn_bninception_rgb_thumos14",
                                  "ssn_inceptionv3_rgb_anet12"])
def test_layer_table_matches_the_reference(name):
    from action_detection_torch.models import SSN

    with open(os.path.join(ROOT, "portbench", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    model = SSN(num_class=cfg["num_class"], base_model=cfg["arch"],
                dropout=0.0)
    shapes = {k: tuple(v.shape)
              for k, v in model.base_model.state_dict().items()}
    k = cfg["num_class"]
    want = layers.scoring_table(
        ARCHS[cfg["reference"]], shapes, cfg["scaled_frame_size"],
        cfg["input"]["crop_size"], cfg["precision"]["stem"],
        cfg["precision"]["trunk"], cfg["feature_dim"], (k + 1) + k + 2 * k)
    assert cfg["score_layers"] == want
