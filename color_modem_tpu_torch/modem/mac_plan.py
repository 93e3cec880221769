"""D2-MAC host-side plan: geometry and level constants of the MAC family.

The port's copy of ``color_modem_tpu/modem/mac_plan.py`` (the same NumPy
code, so the plan's arrays are bit-identical to the JAX package's,
``tests/test_torch_mac.py``); ``modem/mac.py`` holds the design notes.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from color_modem_tpu_torch.standards.base import diff_row, make_matrices


@dataclasses.dataclass(frozen=True)
class MacConfig:
    """D2-MAC line geometry on the 20.25 MHz grid (BO.650-shaped [MEM-M]).

    Segment indices are 0-based sample offsets into the 1296-sample line;
    the published spec counts 1-based, so e.g. chroma "235..583" here is
    the spec's samples 236-584.  Compression checks: active line 52 us =
    1053 samples; luma 697/1053 = 0.662 ~ 2/3 (3:2); chroma 349/1053 =
    0.331 ~ 1/3 (3:1).
    """

    name: str = "d2mac"
    fs: float = 20.25e6
    samples_per_line: int = 1296
    total_lines: int = 625                # 625/50 family raster

    # --- duobinary data burst (D2 = half the D-MAC symbol rate) -----------
    data_symbols: int = 105               # at fs/2 = 10.125 Mbaud
    samples_per_symbol: int = 2           # D2: symbol centers on even n;
    #                                       D-MAC: 1 (20.25 Mbaud, one
    #                                       symbol per grid sample)
    data_start: int = 0                   # burst occupies [0, 210)
    #: 6-symbol line sync word opening every burst (spec-shaped [MEM-L];
    #: the exact published word is not load-bearing — detection is tested
    #: against THIS word, and payload capacity is what matters: 99 bits).
    line_sync_word: tuple = (0, 0, 1, 0, 1, 1)
    data_amplitude: float = 0.4           # levels 0.5 +/- 0.4 -> {0.1,0.5,0.9}

    # --- analog segments ---------------------------------------------------
    clamp_start: int = 226                # DC-restore window [226, 235)
    clamp_len: int = 9                    # past the burst filter tails
    chroma_start: int = 235
    chroma_len: int = 349                 # 3:1 time compression
    luma_start: int = 586
    luma_len: int = 697                   # 3:2 time compression

    # --- levels (documented engineering normalization, see mac.encode) ----
    pedestal: float = 0.5                 # clamp / rest level
    chroma_gain: float = 0.8              # c in [-0.615, 0.615] -> +/-0.49


@dataclasses.dataclass(frozen=True, eq=False)
class MacPlan:
    """Host-side constant bundle (hashable by identity, like ModemPlan)."""

    cfg: MacConfig
    width: int                            # image row width W
    rgb_to_ycc: np.ndarray                # PAL-weight YUV rows (see below)
    ycc_to_rgb: np.ndarray
    halfband: np.ndarray                  # burst shaping interpolator taps


def halfband_taps(half_width: int = 15) -> np.ndarray:
    """Kaiser-windowed half-band interpolator for the 2x burst grid.

    h[m] = sinc(m/2) * kaiser(m): every even offset lands on a sinc zero
    (h[0] = 1), so convolving the zero-stuffed symbol sequence leaves the
    even (symbol-center) samples bit-exact while band-limiting the burst to
    fs/4 = 5.06 MHz — D2-MAC's reduced data bandwidth.
    """
    m = np.arange(-half_width, half_width + 1, dtype=np.float64)
    w = np.i0(8.0 * np.sqrt(np.maximum(0.0, 1.0 - (m / (half_width + 1)) ** 2)))
    w /= np.i0(8.0)
    taps = np.sinc(m / 2.0) * w
    taps[half_width] = 1.0                 # exact center (sinc(0) * w(0))
    return taps


@lru_cache(maxsize=8)
def _cached_plan(width: int, variant: str) -> MacPlan:
    if variant == "d2":
        cfg = MacConfig()
    elif variant == "d":
        # D-MAC: the full-rate original (BO.650's satellite member) — the
        # duobinary burst runs at 20.25 Mbaud, one symbol per grid sample,
        # doubling the per-line payload (204 vs 99 bits) at double the
        # data bandwidth (D2 was derived by halving exactly this burst
        # rate to fit cable networks).  Same analog segments, levels and
        # line geometry — the picture path is IDENTICAL by construction.
        cfg = MacConfig(name="dmac", data_symbols=210, samples_per_symbol=1)
    else:
        raise ValueError(f"unknown MAC variant {variant!r} (want 'd2'|'d')")
    # MAC transmits weighted color-difference components.  The published
    # MAC weighting differs in the third decimal from PAL's; with the mount
    # empty we reuse the framework's exact PAL rows (A.3: U = 0.493(B-Y),
    # V = 0.877(R-Y)) and fold the remaining normalization into
    # cfg.chroma_gain — the round trip is exact either way, and the
    # inverse matrix is computed numerically (standards/base.make_matrices).
    fwd, inv = make_matrices(diff_row("B", 0.493), diff_row("R", 0.877))
    return MacPlan(
        cfg=cfg,
        width=width,
        rgb_to_ycc=np.asarray(fwd, dtype=np.float64),
        ycc_to_rgb=np.asarray(inv, dtype=np.float64),
        halfband=halfband_taps(),
    )


def make_mac_plan(width: int = 720, variant: str = "d2") -> MacPlan:
    """Plan for W-pixel image rows <-> 1296-sample MAC lines.

    ``variant``: "d2" (default, 10.125 Mbaud duobinary burst) or "d"
    (full-rate D-MAC, 20.25 Mbaud, double payload).
    """
    return _cached_plan(int(width), variant)
