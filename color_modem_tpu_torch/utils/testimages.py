"""Synthetic test images: the port's copy of
``color_modem_tpu/utils/testimages.py`` (the same NumPy code, so the same
arguments give the same image bit for bit,
``tests/test_torch_testimages.py``).  Each returns a channels-first
float64 array in [0, 1]: 75% colour bars, a grey ramp, a band-limited
scene, a broadcast test card, a zone plate and SMPTE engineering bars,
the CLI's demo patterns.
"""

from __future__ import annotations

import numpy as np

#: Classic 75% EBU color bars, left to right.
BAR_COLORS_75 = np.array(
    [
        [0.75, 0.75, 0.75],  # white (75%)
        [0.75, 0.75, 0.00],  # yellow
        [0.00, 0.75, 0.75],  # cyan
        [0.00, 0.75, 0.00],  # green
        [0.75, 0.00, 0.75],  # magenta
        [0.75, 0.00, 0.00],  # red
        [0.00, 0.00, 0.75],  # blue
        [0.00, 0.00, 0.00],  # black
    ],
    dtype=np.float64,
)


def color_bars(n_lines: int, n_samples: int) -> np.ndarray:
    """(3, L, N) 75% color bars."""
    idx = np.minimum((np.arange(n_samples) * 8) // n_samples, 7)
    img = BAR_COLORS_75[idx].T  # (3, N)
    return np.broadcast_to(img[:, None, :], (3, n_lines, n_samples)).copy()


def gray_ramp(n_lines: int, n_samples: int) -> np.ndarray:
    """(3, L, N) horizontal luminance ramp — zero chroma by construction."""
    ramp = np.linspace(0.0, 1.0, n_samples)
    return np.broadcast_to(ramp, (3, n_lines, n_samples)).copy()


def smooth_scene(n_lines: int, n_samples: int, seed: int = 0) -> np.ndarray:
    """(3, L, N) band-limited pseudo-natural scene.

    Random field low-passed well inside the chroma bandwidths, so round-trip
    loss is dominated by the modem, not by unrepresentable detail.
    """
    rng = np.random.default_rng(seed)
    img = rng.random((3, n_lines, n_samples))
    # separable box-ish smoothing via FFT low-pass
    for axis, keep in ((1, max(2, n_lines // 16)), (2, max(2, n_samples // 32))):
        spec = np.fft.rfft(img, axis=axis)
        sl = [slice(None)] * 3
        sl[axis] = slice(keep, None)
        spec[tuple(sl)] = 0.0
        img = np.fft.irfft(spec, n=img.shape[axis], axis=axis)
    img -= img.min()
    img /= max(img.max(), 1e-9)
    return 0.1 + 0.8 * img  # stay away from clamp rails


def test_card(n_lines: int, n_samples: int) -> np.ndarray:
    """(3, L, N) broadcast-style test card (PM5544-inspired geometry).

    The classic service pattern rolled into one frame, so a single image
    exercises every modem failure mode at once: a crosshatch (convergence
    — sharp luma edges in both axes), edge castellations (overscan),
    a center circle carrying 75 % color bars (chroma amplitude/phase), a
    5-step gray scale (differential gain), a multiburst of luma gratings
    rising toward the chroma band (cross-color: the finest grating lands
    where a notch decoder rings and a comb stays clean), and a
    half-amplitude checkerboard (DC bounce).  Geometry scales with the
    requested raster instead of pinning the original's 625-line counts.
    """
    L, N = n_lines, n_samples
    yy = np.arange(L)[:, None]
    xx = np.arange(N)[None, :]
    img = np.full((3, L, N), 0.5, dtype=np.float64)

    # crosshatch on the neutral background
    cw, ch = max(8, N // 15), max(6, L // 12)
    lwx, lwy = max(1, N // 360), max(1, L // 288)
    grid = ((xx % cw) < lwx) | ((yy % ch) < lwy)
    img[:, grid] = 0.9

    # castellations: alternating black/white blocks along top and bottom
    blk = (((xx // cw) % 2) == 0)
    cast = np.where(blk, 1.0, 0.0)
    img[:, : ch // 2, :] = cast[: ch // 2 if cast.shape[0] > 1 else 1, :]
    img[:, L - ch // 2 :, :] = cast[:1, :]

    # center circle: white ring, structured interior
    cy, cx = (L - 1) / 2.0, (N - 1) / 2.0
    # sample-aspect correction so the ring is circular on a 4:3 display
    # of the L x N active raster
    sx = (L * 4.0 / 3.0) / N
    r = np.sqrt(((yy - cy) / (L / 2.0)) ** 2
                + ((xx - cx) * sx / (L / 2.0)) ** 2)
    inside = r < 0.92
    ring = (r >= 0.92) & (r < 0.98)

    bands = np.full((3, L, N), 0.5, dtype=np.float64)
    b = [int(L * f) for f in (0.18, 0.38, 0.52, 0.68, 0.84)]
    # color bars band
    bar = BAR_COLORS_75[np.minimum((xx[0] * 8) // N, 7)].T  # (3, N)
    bands[:, b[0] : b[1], :] = bar[:, None, :]
    # gray steps (5)
    steps = (np.minimum((xx[0] * 5) // N, 4)) / 4.0
    bands[:, b[1] : b[2], :] = steps[None, None, :]
    # multiburst: per-segment constant-frequency luma gratings, rising
    # from ~N/64 to ~N/6 cycles per active width
    seg = np.minimum((xx[0] * 5) // N, 4)
    cycles = np.array([N / 64.0, N / 32.0, N / 16.0, N / 9.0, N / 6.0])
    phase = 2.0 * np.pi * cycles[seg] * (xx[0] / N)
    burst = 0.5 + 0.4 * np.sin(phase)
    bands[:, b[2] : b[3], :] = burst[None, None, :]
    # half-amplitude checkerboard
    chk = ((xx // (2 * cw) + yy // (2 * ch)) % 2) == 0
    bands[:, b[3] : b[4], :] = np.where(chk, 0.75, 0.25)[None, b[3] : b[4], :]

    img = np.where(inside[None], bands, img)
    img[:, ring] = 1.0
    return np.clip(img, 0.0, 1.0)


def zone_plate(n_lines: int, n_samples: int, k: float = 0.5) -> np.ndarray:
    """(3, L, N) luma zone plate: cos(pi*k*(x^2+y^2)) about the center.

    Instantaneous spatial frequency grows linearly from DC at the center
    to ``k`` x Nyquist at the edges in BOTH axes — the classic sweep that
    lights up every aliasing and cross-color mechanism at once: the ring
    where horizontal frequency crosses the chroma band shows a notch
    decoder's cross-color as false rainbows, the vertical sweep shows a
    comb's resolution loss, and resamplers show their stopband as moire.
    Zero chroma by construction (equal RGB).
    """
    L, N = n_lines, n_samples
    y = (np.arange(L) - (L - 1) / 2.0) / (L / 2.0)
    x = (np.arange(N) - (N - 1) / 2.0) / (N / 2.0)
    # phase = pi*k/2 * (u^2 * Nu + v^2 * Nv) in samples: d(phase)/du hits
    # k*pi per sample (k x Nyquist) at |u| = 1
    ph = (np.pi * k / 2.0) * (
        (x[None, :] ** 2) * N / 2.0 + (y[:, None] ** 2) * L / 2.0
    )
    img = 0.5 + 0.4 * np.cos(2.0 * ph)
    return np.broadcast_to(img, (3, L, N)).copy()


def smpte_bars(n_lines: int, n_samples: int) -> np.ndarray:
    """(3, L, N) SMPTE EG 1-style engineering color bars.

    Three bands, top to bottom:

    * 67%: the 75% bars (the vectorscope/DG-DP stimulus);
    * 8%: the reverse-order "castellation" strip of blue-only bars
      (I/--/Q alignment strip simplified to the blue-channel form used
      for hue setup: every other bar keeps only its blue component, so
      on a "blue only" monitor the strip matches the bars above exactly
      when hue/saturation are right);
    * 25%: the PLUGE band — -4%/0/+4% pedestal patches around black
      between a 100% white reference and a 7.5% gray, for brightness
      setup.  (The sub-black patch is clamped at 0 here: the frame
      pipeline's contract is RGB in [0, 1]; the +4% patch alone still
      makes the brightness threshold visible.)
    """
    L, N = n_lines, n_samples
    img = np.zeros((3, L, N), dtype=np.float64)
    b1, b2 = int(0.67 * L), int(0.75 * L)
    idx = np.minimum((np.arange(N) * 7) // N, 6)  # 7 bars (no black col)
    bars7 = BAR_COLORS_75[:7]
    img[:, :b1, :] = bars7[idx].T[:, None, :]
    # blue-only strip, reverse-significance order like the EG 1 strip:
    # alternate bars keep a 75% blue, others go black (R/G stay zero)
    keep = np.array([1, 0, 1, 0, 1, 0, 1])[idx]  # alternate on/off
    img[:, b1:b2, :] = 0.0
    img[2, b1:b2, :] = np.where(keep > 0, 0.75, 0.0)[None, :]
    # PLUGE band: white ref | 7.5% gray | black | +4% | black | 0 (sub-
    # black clamped) | black
    seg = np.minimum((np.arange(N) * 7) // N, 6)
    levels = np.array([1.0, 0.075, 0.0, 0.115, 0.0, 0.0, 0.0])[seg]
    img[:, b2:, :] = levels[None, None, :]
    return np.clip(img, 0.0, 1.0)
