"""WAV audio I/O (stdlib ``wave``) for the sound channels.

Port of ``color_modem_tpu/utils/wav.py`` (NumPy only, kept as the port's
own copy).  The intercarrier FM sound (``frame/rf.py``) and the MTS stereo
multiplex (``frame/mts.py``) take audio at the composite rate, one audio
sample per video sample (~13.5 MHz); this module reads and writes 16-bit
PCM files and resamples by linear interpolation between the two grids.
Linear interpolation from 44.1/48 kHz leaves images at multiples of the
source rate, all above ~29 kHz for a 15 kHz-band source: outside the FM
deviation budget and the receiver's audio low-pass.  On the way down the
received audio is already band-limited by that low-pass.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """-> ((channels, n) float32 in [-1, 1], sample_rate).  8/16/32-bit
    PCM."""
    with wave.open(path, "rb") as w:
        ch, width, rate, n = (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                              w.getnframes())
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:  # unsigned 8-bit
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    return x.reshape(-1, ch).T.copy(), rate


def write_wav(path: str, data: np.ndarray, rate: int) -> None:
    """(channels, n) or (n,) float32 in [-1, 1] -> 16-bit PCM."""
    x = np.asarray(data, np.float32)
    if x.ndim == 1:
        x = x[None]
    pcm = np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.T.tobytes())


def resample_linear(x: np.ndarray, rate_in: float, rate_out: float,
                    n_out: int | None = None) -> np.ndarray:
    """(..., n) -> (..., n_out) linear-interpolation resample.

    ``n_out`` defaults to the full duration at the new rate; a longer
    ``n_out`` tiles the source (a clip shorter than a frame keeps the
    channel fed)."""
    n_in = x.shape[-1]
    if n_out is None:
        n_out = int(round(n_in * rate_out / rate_in))
    t_out = np.arange(n_out) * (rate_in / rate_out)
    need = int(np.floor(t_out[-1])) + 2
    if need > n_in:  # tile the source to cover the requested duration
        reps = int(np.ceil(need / n_in))
        x = np.concatenate([x] * reps, axis=-1)
    flat = x.reshape(-1, x.shape[-1])
    out = np.stack([np.interp(t_out, np.arange(flat.shape[-1]), row) for row in flat])
    return out.reshape(x.shape[:-1] + (n_out,)).astype(np.float32)
