"""The port's numpy bilinear resize (``data/transforms.py:resize_bilinear``,
behind ``scale_frame``) is bit-exact against Pillow's
``Image.resize(..., BILINEAR)``, which the JAX pipeline resizes with: mode
``L`` and ``RGB``, InceptionV3's scoring geometry and odd up- and
down-scales."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from action_detection_tpu.data.transforms import GroupScale as JGroupScale

from action_detection_torch.data.transforms import (GroupScale,
                                                    resize_bilinear,
                                                    scale_frame)


def _pil(img: np.ndarray, width: int, height: int) -> np.ndarray:
    mode = "L" if img.ndim == 2 else "RGB"
    return np.asarray(Image.fromarray(img, mode).resize((width, height),
                                                        Image.BILINEAR))


def _frame(h, w, rgb, seed):
    shape = (h, w, 3) if rgb else (h, w)
    return np.random.RandomState(seed).randint(0, 256, size=shape,
                                               dtype=np.uint8)


@pytest.mark.parametrize("rgb", [True, False])
@pytest.mark.parametrize("src,dst", [
    ((256, 340), (341, 452)),     # InceptionV3 scale size from THUMOS frames
    ((37, 53), (71, 101)),        # odd upscale
    ((101, 71), (29, 37)),        # odd downscale
    ((64, 80), (9, 13)),          # downscale by more than 6
    ((5, 7), (5, 11)),            # one axis only
    ((300, 17), (290, 5)),
])
def test_resize_bit_exact_against_pil(rgb, src, dst):
    img = _frame(*src, rgb, seed=src[0] * 7 + dst[1])
    got = resize_bilinear(img, dst[1], dst[0])
    ref = _pil(img, dst[1], dst[0])
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(h=st.integers(1, 48), w=st.integers(1, 48), oh=st.integers(1, 96),
       ow=st.integers(1, 96), rgb=st.booleans(), seed=st.integers(0, 2**16))
def test_resize_bit_exact_any_size(h, w, oh, ow, rgb, seed):
    img = _frame(h, w, rgb, seed)
    np.testing.assert_array_equal(resize_bilinear(img, ow, oh),
                                  _pil(img, ow, oh))


@pytest.mark.parametrize("rgb", [True, False])
@pytest.mark.parametrize("hw,size", [((256, 340), 341), ((256, 340), 256),
                                     ((72, 80), 85), ((90, 60), 37)])
def test_scale_frame_matches_jax_group_scale(rgb, hw, size):
    """``scale_frame`` (and ``GroupScale``) against the JAX package's PIL
    ``GroupScale``, the pass-through at the short edge included."""
    img = _frame(*hw, rgb, seed=size)
    ref = np.asarray(JGroupScale(size)([Image.fromarray(img)])[0])
    got = scale_frame(img, size)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(GroupScale(size)([img])[0], ref)
    if min(hw) == size:
        assert got is img
