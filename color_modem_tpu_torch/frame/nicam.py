"""NICAM-728 digital stereo sound.

Port of ``color_modem_tpu/frame/nicam.py``: near-instantaneously companded
14-bit stereo as a 728-bit/ms DQPSK stream on its own carrier (EN 300 163),
the full chain both ways:

    float audio -> 14-bit PCM -> per-block companding (10-bit mantissa +
    3-bit scale factor) -> parity with signalling-in-parity scale factors
    -> 44x16 bit interleave -> PRBS scrambler -> frame (FAW + control +
    data) -> DQPSK on a carrier -> differential detection -> FAW
    frame-alignment search -> majority-decoded scale factors -> audio

Where it departs from EN 300 163, as the JAX package does:

* a symbol is exactly ``round(fs/364e3)`` samples, so symbol centres are
  integers (no fractional-delay resampler);
* the 3 scale bits per channel ride the parity of 3 sample groups (11/11/10
  of the channel's 32), majority-decoded, instead of the standard's
  54-sample pattern;
* transmitter and receiver share the sample clock, so symbol timing is
  known; carrier phase and frame alignment are not: DQPSK is differential
  and the FAW is found by correlation over all 364 symbol offsets.

The bit plumbing is integer gathers and XORs over ``(frames, 728)``
tensors, bit-equal to the JAX package; the passband is one mix and
``dsp/apply.py::fir_same_fft`` (a single padded transform, as the JAX
package chose).  Constant tables (the interleave order, the PRBS, the FAW)
are uploaded once per device, and nothing on the way reads a value back
to the host: the FAW search's ``argmax`` stays on the device.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.apply import fir_same_fft
from color_modem_tpu_torch.dsp.nco import f32
from color_modem_tpu_torch.dsp.stream import plan_memo
from color_modem_tpu_torch.utils import prng

TWO_PI = 2.0 * np.pi

#: frame structure (EN 300 163): FAW + 5 control + 11 additional data,
#: then 64 samples x 11 bits of sound
FAW = (0, 1, 0, 0, 1, 1, 1, 0)
N_CONTROL = 5
N_AD = 11
N_HEADER = len(FAW) + N_CONTROL + N_AD      # 24
N_SOUND = 704                                # 64 * 11
FRAME_BITS = N_HEADER + N_SOUND              # 728
SYMBOLS_PER_FRAME = FRAME_BITS // 2          # 364

#: audio geometry: 32 samples per channel per frame (32 kHz nominal)
BLOCK = 32

#: nominal NICAM-I sound carrier offset used as the default passband
CARRIER_HZ = 5.85e6
NOMINAL_BAUD = 364e3

#: companding: 14-bit PCM to 10-bit mantissa, shifts 0..4 (5 ranges)
PCM_BITS = 14
MANT_BITS = 10
MAX_SHIFT = 4

#: per-channel sample-group boundaries carrying the 3 scale bits
_SF_GROUPS = ((0, 11), (11, 22), (22, 32))


def _interleave_order() -> np.ndarray:
    """Transmission order of the 704 sound bits: written into a 44x16
    matrix row-wise, read column-wise (adjacent stream bits land 16
    apart, so a DQPSK symbol error never hits two bits of one sample)."""
    return np.arange(N_SOUND).reshape(44, 16).T.reshape(-1)


_ILV = _interleave_order()
_DILV = np.argsort(_ILV)


@lru_cache(maxsize=1)
def _prbs() -> np.ndarray:
    """720-bit scrambler sequence: x^9 + x^4 + 1, seed all-ones, restarted
    every frame after the FAW (frames descramble independently)."""
    reg = [1] * 9
    out = []
    for _ in range(FRAME_BITS - len(FAW)):
        bit = reg[8] ^ reg[3]
        out.append(reg[8])
        reg = [bit] + reg[:8]
    return np.asarray(out, np.int32)


def _sample_groups() -> tuple[np.ndarray, np.ndarray]:
    """(chan, group) of the 64 transmitted samples A1 B1 A2 B2 ...: sample
    2k is channel A, 2k+1 channel B; the in-channel index k picks the
    scale-bit group."""
    k = np.arange(64) // 2
    chan = np.arange(64) % 2
    group = np.where(k < _SF_GROUPS[0][1], 0, np.where(k < _SF_GROUPS[1][1], 1, 2))
    return chan, group


#: Gray-coded DQPSK phase increment for dibit value b0*2 + b1
_DQPSK_PHASE = {0: 0.0, 1: -np.pi / 2, 3: np.pi, 2: np.pi / 2}
#: the same increments in quarter turns mod 4
_DQPSK_QUARTERS = (0, 3, 1, 2)
#: inverse: quadrant q (step q*90 deg) -> dibit
_QUAD_DIBIT = (0, 2, 3, 1)


@lru_cache(maxsize=16)
def _tables(device: torch.device) -> dict:
    """The constant tables on ``device``, uploaded once: int64 index
    tables, int32 bit tables, float32 quarter-turn cos/sin."""
    chan, group = _sample_groups()
    host = {
        "ilv": _ILV, "dilv": _DILV, "chan": chan, "group": group,
        "quarters": np.asarray(_DQPSK_QUARTERS, np.int64),
        "prbs": _prbs(), "faw": np.asarray(FAW, np.int32),
        "quad_dibit": np.asarray(_QUAD_DIBIT, np.int32),
        "mant_shifts": np.arange(MANT_BITS - 1, -1, -1, dtype=np.int32),
        "sf_shifts": np.arange(2, -1, -1, dtype=np.int32),
        "quarter_cos": np.asarray([1.0, 0.0, -1.0, 0.0], np.float32),
        "quarter_sin": np.asarray([0.0, 1.0, 0.0, -1.0], np.float32),
    }
    return {k: torch.tensor(v, device=device) for k, v in host.items()}


@lru_cache(maxsize=64)
def _control_bits(control: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([(control >> (N_CONTROL - 1 - i)) & 1 for i in range(N_CONTROL)],
                        dtype=torch.int32, device=device)


def _pow2(shift: torch.Tensor) -> torch.Tensor:
    """2^shift as float32 (``1 << shift``)."""
    return torch.bitwise_left_shift(torch.ones_like(shift), shift).to(torch.float32)


# ---------------------------------------------------------------------------
# Companding (near-instantaneous, per 32-sample block)
# ---------------------------------------------------------------------------


def _quantize14(x) -> torch.Tensor:
    s = torch.clamp(torch.round(torch.as_tensor(x, dtype=torch.float32) * 8192.0), -8192, 8191)
    return s.to(torch.int32)


def compand(x) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., n_blocks, 32) float audio -> (10-bit mantissas, shifts).

    The shift is the block's number of discarded LSBs: 0 for quiet blocks
    (lossless), up to 4 for full-scale ones (top 10 of 14 bits kept)."""
    s = _quantize14(x)
    peak = torch.amax(torch.abs(s), dim=-1, keepdim=True)
    # smallest shift with round(s / 2^shift) in [-512, 511]
    shift = torch.zeros_like(peak)
    for k in range(1, MAX_SHIFT + 1):
        shift = torch.where(peak > (512 << (k - 1)) - 1, k, shift)
    mant = torch.clamp(torch.round(s.to(torch.float32) / _pow2(shift)), -512, 511)
    return mant.to(torch.int32), shift[..., 0]


def expand(mant: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`compand` -> float audio in [-1, 1]."""
    s = mant.to(torch.float32) * _pow2(shift)[..., None]
    return s / 8192.0


# ---------------------------------------------------------------------------
# Bit plumbing: parity + signalling-in-parity, interleave, scrambler
# ---------------------------------------------------------------------------


def _sound_bits(mant: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(F, 64) mantissas + (F, 2) shifts -> (F, 704) sound bits.

    Each sample is 10 bits MSB-first (two's complement) + 1 even parity
    bit over the 6 MSBs, with the channel's scale bits XORed into its
    groups' parity bits."""
    t = _tables(mant.device)
    u = torch.bitwise_and(mant, 0x3FF).to(torch.int32)
    bits = torch.bitwise_right_shift(u[..., None], t["mant_shifts"]) & 1   # (F, 64, 10)
    parity = torch.remainder(torch.sum(bits[..., :6], dim=-1, dtype=torch.int32), 2)
    sf = torch.bitwise_right_shift(shift[..., None], t["sf_shifts"]) & 1  # (F, 2, 3)
    mark = sf[:, t["chan"], t["group"]]                                     # (F, 64)
    parity = torch.remainder(parity + mark, 2)
    return torch.cat([bits, parity[..., None]], dim=-1).reshape(
        *mant.shape[:-1], N_SOUND)


def _parse_sound_bits(bits: torch.Tensor):
    """(F, 704) -> (mant (F, 64), shifts (F, 2), parity_err (F, 64)).

    Scale bits come back by majority over each group's parity residue; the
    residue left after removing the decoded scale bit is the per-sample
    parity error flag."""
    t = _tables(bits.device)
    chan, group = t["chan"], t["group"]
    b = bits.reshape(*bits.shape[:-1], 64, MANT_BITS + 1)
    u = torch.sum(torch.bitwise_left_shift(b[..., :MANT_BITS], t["mant_shifts"]), dim=-1,
                  dtype=torch.int32)
    mant = torch.where(u >= 512, u - 1024, u)                  # sign-extend
    parity = torch.remainder(torch.sum(b[..., :6], dim=-1, dtype=torch.int32), 2)
    residue = torch.remainder(parity + b[..., MANT_BITS], 2)  # (F, 64)
    sf_bits = []
    for c in range(2):
        per_group = []
        for g, (lo, hi) in enumerate(_SF_GROUPS):
            sel = ((chan == c) & (group == g)).to(torch.int32)
            votes = torch.sum(residue * sel, dim=-1, dtype=torch.int32)
            per_group.append((votes * 2 > (hi - lo)).to(torch.int32))
        sf_bits.append(per_group)
    shift = torch.stack([sf_bits[c][0] * 4 + sf_bits[c][1] * 2 + sf_bits[c][2]
                         for c in range(2)], dim=-1)
    shift = torch.clamp(shift, max=MAX_SHIFT)
    decoded_mark = torch.stack([sf_bits[c][g] for c in range(2) for g in range(3)],
                               dim=-1).reshape(*bits.shape[:-1], 2, 3)[..., chan, group]
    err = torch.remainder(residue + decoded_mark, 2)
    return mant, shift, err


# ---------------------------------------------------------------------------
# Frame assembly / parse
# ---------------------------------------------------------------------------


def nicam_frames(left, right, control: int = 0b00000) -> torch.Tensor:
    """Stereo audio -> (F, 728) int32 transmission bit frames.

    ``left``/``right``: 1-D float audio in [-1, 1], length a multiple of
    32 (one block per frame and channel).  Companding, parity and
    signalling, interleave and scrambling run batched over frames."""
    left = torch.as_tensor(left, dtype=torch.float32)
    right = torch.as_tensor(right, dtype=torch.float32, device=left.device)
    if left.shape != right.shape or left.ndim != 1:
        raise ValueError(f"left/right must be equal-length 1-D, got "
                         f"{tuple(left.shape)} vs {tuple(right.shape)}")
    if left.shape[0] % BLOCK:
        raise ValueError(f"audio length must be a multiple of {BLOCK}, got {left.shape[0]}")
    dev = left.device
    t = _tables(dev)
    n_frames = left.shape[0] // BLOCK
    la, ls = compand(left.reshape(n_frames, BLOCK))
    ra, rs = compand(right.reshape(n_frames, BLOCK))
    # transmission sample order A1 B1 A2 B2 ...
    mant = torch.stack([la, ra], dim=-1).reshape(n_frames, 2 * BLOCK)
    shift = torch.stack([ls, rs], dim=-1)
    sound = _sound_bits(mant, shift)[..., t["ilv"]]
    cbits = _control_bits(int(control), dev).expand(n_frames, N_CONTROL)
    ad = torch.zeros(n_frames, N_AD, dtype=torch.int32, device=dev)
    payload = torch.remainder(torch.cat([cbits, ad, sound], dim=-1) + t["prbs"], 2)
    return torch.cat([t["faw"].expand(n_frames, len(FAW)), payload], dim=-1)


def parse_frames(frames: torch.Tensor):
    """(F, 728) received bits -> ``(left, right, report)``, the inverse of
    :func:`nicam_frames`.  Samples with a parity error are kept (audible
    noise, as in a receiver before concealment) and counted in
    ``report["parity_errors"]`` (F,); ``report["faw_ok"]`` (F,) and
    ``report["control"]`` (F, 5) come with it."""
    f = torch.as_tensor(frames).to(torch.int32)
    t = _tables(f.device)
    payload = torch.remainder(f[..., len(FAW):] + t["prbs"], 2)
    control = payload[..., :N_CONTROL]
    sound = payload[..., N_CONTROL + N_AD:][..., t["dilv"]]
    mant, shift, err = _parse_sound_bits(sound)
    pairs = mant.reshape(*mant.shape[:-1], BLOCK, 2)
    left = expand(pairs[..., 0], shift[..., 0]).reshape(-1)
    right = expand(pairs[..., 1], shift[..., 1]).reshape(-1)
    faw_ok = torch.all(f[..., :len(FAW)] == t["faw"], dim=-1)
    return left, right, {"faw_ok": faw_ok, "control": control,
                         "parity_errors": torch.sum(err, dim=-1, dtype=torch.int32)}


# ---------------------------------------------------------------------------
# DQPSK passband
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class NicamPlan:
    """Host constants of one NICAM passband (hashable by identity)."""

    fs: float               # sample rate (the composite or RF grid's)
    fc: float               # carrier, Hz
    spb: int                # samples per symbol (integer by design)
    shaping: np.ndarray     # TX pulse-shaping low-pass taps
    matched: np.ndarray     # RX matched low-pass taps

    @property
    def baud(self) -> float:
        return self.fs / self.spb


def _rrc_taps(spb: int, beta: float = 1.0, span: int = 8) -> np.ndarray:
    """Root-raised-cosine pulse (half at TX, half at RX: an ISI-free raised
    cosine at the integer symbol centres).  ``beta`` < 0.9 needs the
    longer span 16."""
    if beta < 0.9:
        span = max(span, 16)
    ntaps = span * spb + 1
    t = (np.arange(ntaps) - ntaps // 2) / spb
    num = np.cos((1 + beta) * np.pi * t) + np.sinc(
        (1 - beta) * t
    ) * (1 - beta) * np.pi / (4 * beta)
    den = 1 - (4 * beta * t) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        h = num / den
    # singular points of the RRC closed form
    sing = np.isclose(np.abs(den), 0.0)
    h[sing] = beta / 2 * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta))
    )
    return (h / np.sum(h)).astype(np.float64)


def make_nicam_plan(plan, fc: float = CARRIER_HZ) -> NicamPlan:
    """Symbol grid and the split raised-cosine shaping on ``plan``'s
    composite rate."""
    fs = plan.fs
    spb = int(round(fs / NOMINAL_BAUD))
    if fs / 2.0 <= fc + 1.2 * NOMINAL_BAUD:
        raise ValueError(
            f"carrier {fc/1e6:.2f} MHz + sidebands exceeds Nyquist at fs={fs/1e6:.2f} MHz")
    h = _rrc_taps(spb)
    return NicamPlan(fs=fs, fc=fc, spb=spb, shaping=h, matched=h)


def _tail_symbols(nplan: NicamPlan) -> int:
    """Silent tail symbols so the last real symbol keeps full pulse support
    under the 'same'-mode matched filter."""
    return len(nplan.shaping) // (2 * nplan.spb) + 1


def _carrier_phase_ramp(nplan: NicamPlan, n: int, device) -> torch.Tensor:
    """2*pi*fc/fs * t over ``n`` samples, float32 as the JAX package forms
    it (the transmitter and the receiver form it alike, so its rounding at
    large t cancels in the mix)."""
    return f32(TWO_PI * nplan.fc / nplan.fs) * torch.arange(n, dtype=torch.float32,
                                                            device=device)


def nicam_modulate(nplan: NicamPlan, frames: torch.Tensor,
                   carrier_phase: float = 0.0) -> torch.Tensor:
    """(F, 728) bit frames -> (n,) real passband at ``nplan.fs``.

    Differential QPSK off a prepended reference symbol (the receiver needs
    no absolute carrier phase and loses no bit to the differential start).
    The symbol phase is counted in quarter turns mod 4, exactly (the JAX
    package sums the increments as float32 radians, which drift by up to
    ~1e-3 rad over a few thousand symbols).  ``carrier_phase`` rotates the
    transmitter's carrier against the receiver's mixers."""
    f = torch.as_tensor(frames).to(torch.int32).reshape(-1, 2)
    dev = f.device
    t = _tables(dev)
    dibit = (f[:, 0] * 2 + f[:, 1]).to(torch.int64)
    quarter = torch.remainder(torch.cumsum(t["quarters"][dibit], dim=0), 4)
    zi = torch.cat([t["quarter_cos"][:1], t["quarter_cos"][quarter]])
    zq = torch.cat([t["quarter_sin"][:1], t["quarter_sin"][quarter]])
    n_sym = zi.shape[0] + _tail_symbols(nplan)
    # impulse trains at the symbol centres, shaped by the TX RRC
    upi = torch.zeros(n_sym * nplan.spb, dtype=torch.float32, device=dev)
    upq = torch.zeros_like(upi)
    upi[: zi.shape[0] * nplan.spb : nplan.spb] = zi
    upq[: zq.shape[0] * nplan.spb : nplan.spb] = zq
    i = fir_same_fft(upi, nplan.shaping) * nplan.spb
    q = fir_same_fft(upq, nplan.shaping) * nplan.spb
    w = _carrier_phase_ramp(nplan, i.shape[0], dev) + f32(carrier_phase)
    return i * torch.cos(w) - q * torch.sin(w)


def _symbol_samples(nplan: NicamPlan, x: torch.Tensor):
    """Passband -> the symbol-rate (i, q) pair on the known timing grid."""
    w = _carrier_phase_ramp(nplan, x.shape[-1], x.device)
    zi = fir_same_fft(x * (2.0 * torch.cos(w)), nplan.matched)
    zq = fir_same_fft(x * (-2.0 * torch.sin(w)), nplan.matched)
    return zi[..., :: nplan.spb], zq[..., :: nplan.spb]


def nicam_demodulate(nplan: NicamPlan, x: torch.Tensor, n_frames: int | None = None):
    """Real passband -> (bit frames (F, 728), lock report).

    Differential detection (``z * conj(z_prev)``), then the FAW
    frame-alignment search: the FAW bits correlated at all 364 symbol
    offsets in one gather and sum, the peak (first on a tie) sets the
    frame boundary.  The report's ``offset_bits`` and ``faw_score`` stay
    on the device."""
    zi, zq = _symbol_samples(nplan, x)
    dev = zi.device
    t = _tables(dev)
    dre = zi[..., 1:] * zi[..., :-1] + zq[..., 1:] * zq[..., :-1]
    dim = zq[..., 1:] * zi[..., :-1] - zi[..., 1:] * zq[..., :-1]
    ang = torch.atan2(dim, dre)
    quad = torch.remainder(torch.round(ang / (np.pi / 2)).to(torch.int64), 4)
    dibit = t["quad_dibit"][quad]
    bits = torch.stack([torch.div(dibit, 2, rounding_mode="floor"),
                        torch.remainder(dibit, 2)], dim=-1).reshape(-1)
    n_total = bits.shape[0]
    max_frames = n_total // FRAME_BITS
    if n_frames is None:
        n_frames = max_frames - 1 if max_frames > 1 else max_frames
    pm = 1.0 - 2.0 * bits.to(torch.float32)              # 0/1 -> +1/-1
    fm = 1.0 - 2.0 * t["faw"].to(torch.float32)
    offs = torch.arange(0, FRAME_BITS, 2, device=dev)[:, None, None]
    idx = (offs + torch.arange(n_frames, device=dev)[None, :, None] * FRAME_BITS
           + torch.arange(len(FAW), device=dev)[None, None, :])
    fits = idx[:, -1, -1] < n_total
    corr = torch.sum(pm[torch.clamp(idx, 0, n_total - 1)] * fm, dim=(1, 2))
    scores = torch.where(fits, corr, -torch.inf)
    best = torch.argmax(scores)
    off = best * 2
    fidx = (off + torch.arange(n_frames, device=dev)[:, None] * FRAME_BITS
            + torch.arange(FRAME_BITS, device=dev))
    frames = bits[torch.clamp(fidx, 0, n_total - 1)]
    return frames, {"offset_bits": off, "faw_score": torch.amax(scores), "n_frames": n_frames}


# ---------------------------------------------------------------------------
# Riding the RF layer: NICAM next to the FM sound carrier
# ---------------------------------------------------------------------------

#: NICAM carrier offset above the FM sound carrier (clears the FM Carson
#: band, ~130 kHz, plus NICAM's own 0.4-rolloff sideband, ~255 kHz)
RF_OFFSET_HZ = 0.5e6

#: NICAM carrier amplitude in the RF layer's units (-20 dB vs peak vision
#: carrier; ENV_BLANK is 0.75 of the unit scale)
RF_AMP = 0.075

#: spectral roll-off on the RF channel (EN 300 163 System B/G: 0.4)
RF_BETA = 0.4


def make_nicam_rf_plan(rfp, offset: float = RF_OFFSET_HZ) -> NicamPlan:
    """A NICAM plan on the RF sample grid, carrier at ``FM sound + offset``
    (built once per (RF plan, offset)).

    The receiver's matched filter is the RRC composed with a sharp channel
    selector at complex baseband: flat across NICAM's (1+beta)*baud/2 band
    and ~60 dB down at the FM carrier's Carson band edge, which sits only
    0.5 MHz below at 2.7x NICAM's amplitude."""
    def build() -> NicamPlan:
        fs_rf = rfp.fs_rf
        fc = rfp.f_snd + offset
        half = (1 + RF_BETA) * NOMINAL_BAUD / 2
        snd_half = 2.0 * (rfp.snd_dev + 15e3)
        if fc - half < rfp.f_snd + snd_half:
            raise ValueError(
                f"NICAM at {fc/1e6:.2f} MHz overlaps the FM sound Carson "
                f"band — raise offset (>= {((snd_half + half))/1e6:.2f} MHz)")
        if fs_rf / 2.0 <= fc + 1.5 * half:
            raise ValueError(
                f"NICAM at {fc/1e6:.2f} MHz exceeds Nyquist at the RF rate "
                f"{fs_rf/1e6:.1f} MHz — raise r")
        spb = int(round(fs_rf / NOMINAL_BAUD))
        h = _rrc_taps(spb, beta=RF_BETA)
        # pass NICAM's sidebands (to ~half + 25 kHz), stop by the FM
        # carrier's Carson edge (offset - snd_half), where the mix puts it
        sel = design.freq_sampled_taps(
            fs_rf,
            lambda f: design.raised_cosine_bandpass_response(
                f, 0.0, half + 25e3, max(offset - snd_half - half - 50e3, 60e3)),
            8193,
        )
        return NicamPlan(fs=fs_rf, fc=fc, spb=spb, shaping=h, matched=np.convolve(h, sel))
    return plan_memo(rfp, ("nicam", float(offset)), build)


def _head_samples(nplan: NicamPlan) -> int:
    """Guard before the burst inside an RF block, whole symbols: half the
    receive filter's span, so the reference symbol sees the interferers
    with the filter's full support."""
    half_sym = len(nplan.matched) // (2 * nplan.spb) + 1
    return half_sym * nplan.spb


def nicam_capacity(rfp, rf_shape: tuple) -> int:
    """Whole NICAM frames that fit an RF block of ``rf_shape`` (B, L,
    N*r): 728 bits per ~1 ms."""
    nplan = make_nicam_rf_plan(rfp)
    n_total = rf_shape[-2] * rf_shape[-1]
    per_frame = SYMBOLS_PER_FRAME * nplan.spb
    overhead = (1 + _tail_symbols(nplan)) * nplan.spb + _head_samples(nplan)
    return max(0, (n_total - overhead) // per_frame)


def nicam_on_rf(rfp, rf: torch.Tensor, left, right) -> torch.Tensor:
    """Add the NICAM carrier to an RF block (B, L, N*r): the burst fills
    the front of each item's stream.  Audio length must be ``32 *
    nicam_capacity(...)`` or less per channel."""
    nplan = make_nicam_rf_plan(rfp)
    _, l, nr = rf.shape
    frames = nicam_frames(left, right)
    x = nicam_modulate(nplan, frames)
    head = _head_samples(nplan)
    if head + x.shape[0] > l * nr:
        raise ValueError(
            f"{frames.shape[0]} NICAM frames need {head + x.shape[0]} RF "
            f"samples, block has {l * nr} — see nicam_capacity")
    burst = torch.nn.functional.pad(x, (head, l * nr - x.shape[0] - head))
    return rf + RF_AMP * burst.reshape(l, nr)[None]


def nicam_from_rf(rfp, rf: torch.Tensor, n_frames: int):
    """``(left, right, report, lock)`` from the first batch item's stream
    of an RF block."""
    nplan = make_nicam_rf_plan(rfp)
    stream = rf.reshape(rf.shape[0], -1)[0]
    rx_frames, lock = nicam_demodulate(nplan, stream, n_frames=n_frames)
    left, right, rep = parse_frames(rx_frames)
    return left, right, rep, lock


def nicam_roundtrip(plan, left, right, *, noise_sigma: float = 0.0,
                    carrier_phase: float = 0.0,
                    key: prng.Key | None = None):
    """Encode, optionally impair, decode: ``(left, right, report, lock)``.

    ``noise_sigma`` is relative to the transmitted signal's RMS, the noise
    ``normal(key, ...)`` (``key`` None: ``PRNGKey(0)``, as in JAX);
    ``carrier_phase`` rotates the transmitter's carrier."""
    nplan = make_nicam_plan(plan)
    frames = nicam_frames(left, right)
    x = nicam_modulate(nplan, frames, carrier_phase=carrier_phase)
    if noise_sigma > 0.0:
        if key is None:
            key = prng.PRNGKey(0)
        rms = torch.sqrt(torch.mean(x * x))
        x = x + noise_sigma * rms * prng.normal(key, x.shape, x.device)
    rx_frames, lock = nicam_demodulate(nplan, x, n_frames=frames.shape[0])
    return parse_frames(rx_frames) + (lock,)
