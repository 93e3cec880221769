"""Ghost-cancellation equalizer from a transmitted reference line.

Port of ``color_modem_tpu/frame/equalize.py``.  A Ghost Cancellation
Reference (ITU-R BT.1124) is a known broadband chirp: the receiver
compares what arrived with what was sent, estimates the channel and
applies an inverse FIR.  This is that receiver path for
``frame/channel.py::impair`` (ghost, chroma gain and phase: any linear
distortion) and for an RF-layer ghost (``frame/rf.py::rf_ghost``, with the
``pivot`` of ``RFPlan.video_zero``).

    gcr  = gcr_record(plan)                     # what was transmitted
    taps = design_equalizer(plan, rx_gcr)       # rx_gcr: the same, received
    out  = decode(apply_equalizer(comp, taps))

The estimate is frequency-domain ridge regression on the device, on
``torch.fft.rfft``/``irfft`` at the record's own (non-power-of-two)
length: the JAX package's real-DFT matmuls (``dsp/rdft.py``) have the same
DC and Nyquist semantics and are not ported.  A ``(k >= 2, N)`` record of
:func:`gcr_record` is the cyclic-prefix form: the first line settles the
channel, so the rest is an exact circular convolution.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp.design import tukey


def gcr_line(plan, samples: int | None = None) -> np.ndarray:
    """BT.1124-style reference line: a raised-cosine-windowed linear chirp
    sweeping 0.005-0.495 cycles/sample on a mid-grey pedestal, within
    [0, 1] (host float32)."""
    n = samples if samples is not None else plan.n_samples
    t = np.arange(n, dtype=np.float64)
    f0, f1 = 0.005, 0.495  # cycles/sample at the ends of the sweep
    phase = 2.0 * np.pi * (f0 * t + (f1 - f0) * t * t / (2.0 * (n - 1)))
    w = np.ones(n)
    edge = max(8, n // 32)
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(edge) / edge)
    w[:edge], w[-edge:] = ramp, ramp[::-1]
    return (0.5 + 0.45 * w * np.sin(phase)).astype(np.float32)


def gcr_record(plan, lines: int = 3, samples: int | None = None) -> np.ndarray:
    """(lines, N) cyclic-prefix GCR record: one prefix line (the period's
    last line) and a chirp spanning the remaining ``(lines-1)*N`` samples.
    ``samples``: the row width (default ``plan.n_samples``)."""
    if lines < 2:
        raise ValueError("a cyclic record needs a prefix + >= 1 line")
    n = plan.n_samples if samples is None else int(samples)
    x = gcr_line(plan, (lines - 1) * n)
    return np.concatenate([x[-n:], x]).reshape(lines, n)


def gcr_record_guarded(plan, lines: int = 3, samples: int | None = None) -> np.ndarray:
    """(lines+1, N) cyclic GCR record with a postfix guard line (the
    period's first line again), for channels with lookahead such as the RF
    hop's centred filters; hand :func:`design_equalizer` the received
    ``[:lines]``."""
    rec = gcr_record(plan, lines, samples)
    return np.concatenate([rec, rec[1:2]])


def ntaps_for_delay(plan, ghost_delay_us: float, echoes: int = 3, base: int = 129) -> int:
    """Equalizer length whose half-span reaches ``echoes`` correction taps
    of a ghost at ``ghost_delay_us``, with margin for the taper; capped
    just under one line (the cyclic record's alias-free reach)."""
    d = int(np.ceil(ghost_delay_us * 1e-6 * plan.fs))
    half = max((base - 1) // 2, int(np.ceil(echoes * max(d, 1) / 0.6)))
    half = min(half, plan.n_samples - 1)
    return 2 * half + 1


@lru_cache(maxsize=32)
def _host_on(kind: str, n: int, device: torch.device) -> torch.Tensor:
    """The chirp of ``n`` samples or the ``n``-tap taper, float32 on
    ``device``, uploaded once."""
    host = gcr_line(None, n) if kind == "gcr" else tukey(n, alpha=0.4)
    return torch.tensor(host, dtype=torch.float32, device=device)


def design_equalizer(plan, received, ntaps: int = 129, reg: float = 1e-3,
                     pivot: float = 0.0) -> torch.Tensor:
    """Received GCR -> (ntaps,) inverse-channel FIR, on ``received``'s device.

    ``received``: an ``(N,)`` line (zero-padded linear estimate) or a
    ``(k >= 2, N)`` record from :func:`gcr_record` (cyclic estimate over
    the lines after the prefix).  Ridge regression with an identity prior:
    ``H = R S* / (|S|^2 + reg ps) + (1 - W)``, ``W = |S|^2 / (|S|^2 + reg
    ps)``, then ``E = H* / (|H|^2 + reg mean|H|^2)``, windowed to ``ntaps``
    around zero delay with a Tukey taper.  ``pivot``: the video level about
    which the channel is linear (0 for a composite channel,
    ``RFPlan.video_zero`` for an RF one); use the same in
    :func:`apply_equalizer`.
    """
    if ntaps % 2 != 1:
        raise ValueError(f"ntaps must be odd, got {ntaps}")
    received = torch.as_tensor(received)
    dev = received.device
    if received.ndim == 2:
        if received.shape[0] < 2:
            raise ValueError("a cyclic GCR record needs >= 2 lines (gcr_record)")
        r = received[1:].reshape(-1).to(torch.float32) - pivot
        s = _host_on("gcr", (received.shape[0] - 1) * received.shape[-1], dev) - pivot
        nfft = s.shape[-1]  # exact circular convolution, no padding
    else:
        r = received.to(torch.float32) - pivot
        s = _host_on("gcr", received.shape[-1], dev) - pivot
        nfft = int(2 ** np.ceil(np.log2(s.shape[-1] + ntaps)))
    if ntaps > nfft - 1:
        raise ValueError(f"ntaps {ntaps} exceeds the record's {nfft}-sample period")
    sf = torch.fft.rfft(s, n=nfft)
    rf = torch.fft.rfft(r, n=nfft)
    sr, si, rr, ri = sf.real, sf.imag, rf.real, rf.imag
    ps2 = sr * sr + si * si
    den = ps2 + reg * torch.mean(ps2)
    w = ps2 / den
    hr = (rr * sr + ri * si) / den + (1.0 - w)
    hi = (ri * sr - rr * si) / den
    ph2 = hr * hr + hi * hi
    d2 = ph2 + reg * torch.mean(ph2)
    e = torch.fft.irfft(torch.complex(hr / d2, -hi / d2), n=nfft)
    half = (ntaps - 1) // 2
    taps = torch.cat([e[-half:], e[: half + 1]])
    return taps * _host_on("taper", ntaps, dev)


def apply_equalizer(comp: torch.Tensor, taps: torch.Tensor, pivot: float = 0.0) -> torch.Tensor:
    """Filter a (..., L, N) composite with device taps along the
    concatenated line stream (the time axis a ghost rides), about
    ``pivot``: ``out = pivot + e * (comp - pivot)``, 'same' centring with
    zero edges, by one power-of-two FFT over the stream."""
    lead, (l, n) = comp.shape[:-2], comp.shape[-2:]
    ntaps = taps.shape[-1]
    stream = comp.reshape(*lead, l * n) - pivot
    nfft = int(2 ** np.ceil(np.log2(l * n + ntaps)))
    y = torch.fft.irfft(torch.fft.rfft(stream, n=nfft) * torch.fft.rfft(taps, n=nfft), n=nfft)
    half = (ntaps - 1) // 2
    out = y[..., half : half + l * n].reshape(*lead, l, n) + pivot
    return out.to(comp.dtype)
