"""The port's demo patterns (``color_modem_tpu_torch/utils/testimages.py``)
against the JAX package's: bit-identical at the main path's 480x720 and at
the 576x1440 grid of SECAM's and teletext's quality width."""

import numpy as np
import pytest

from color_modem_tpu.utils import testimages as jti
from color_modem_tpu_torch.utils import testimages as tti
from torch_threads import one_torch_thread  # noqa: F401

GENERATORS = ("color_bars", "gray_ramp", "test_card", "zone_plate", "smpte_bars")


@pytest.mark.parametrize("size", [(480, 720), (576, 1440)], ids=["480x720", "576x1440"])
@pytest.mark.parametrize("name", GENERATORS)
def test_generator_is_bit_identical(name, size):
    got, want = getattr(tti, name)(*size), getattr(jti, name)(*size)
    assert got.shape == (3, *size) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_bar_table_and_zone_plate_sweep():
    np.testing.assert_array_equal(tti.BAR_COLORS_75, jti.BAR_COLORS_75)
    np.testing.assert_array_equal(tti.zone_plate(64, 720, k=0.8), jti.zone_plate(64, 720, k=0.8))
