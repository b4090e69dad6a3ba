"""yolov4-p7 (the Scaled-YOLOv4 large family's widest model, at 128 pixels)
through the port against the JAX package, on the CPU: the fp32 forward,
the heads with every conv int8 and the ``Detector`` of
``tests/test_torch_large.py``, with its bodies, params fixture and
tolerances, in a file of its own so that the suite's parallel workers
(one file a worker) run it beside p5's and p6's.
"""

import pytest

from tests import test_torch_large as large
from tests.test_torch_large import model  # noqa: F401  (the params fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("model", ["yolov4-p7"], indirect=True)
def test_fp32_forward_matches_jax(model):
    """``test_torch_large.test_fp32_forward_matches_jax`` on p7: five
    logistic heads of 340 channels."""
    large.test_fp32_forward_matches_jax(model)


@pytest.mark.parametrize("model", ["yolov4-p7"], indirect=True)
def test_every_conv_int8_heads_match_jax_bit_for_bit(model):
    """``test_torch_large.test_every_conv_int8_heads_match_jax_bit_for_bit``
    on p7: input widths 480, 960, 1152, 1600, 1920 and split groups 480 +
    480, 960 + 640, 1280 + 640, 960 + 960."""
    large.test_every_conv_int8_heads_match_jax_bit_for_bit(model)


@pytest.mark.parametrize("model", ["yolov4-p7"], indirect=True)
def test_detector_matches_jax(model):
    """``test_torch_large.test_detector_matches_jax`` on p7: five
    new_coords heads of four anchors through K1 and K2."""
    large.test_detector_matches_jax(model)
