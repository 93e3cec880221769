"""The port's WAV I/O and resampler (``color_modem_tpu_torch/utils/wav.py``)
against the JAX package's copy, and a 48 kHz file through the intercarrier
FM sound channel, on the CPU.

Bounds: ``resample_linear`` bit-equal to the JAX package's; files written
by either copy read back equal by both; the file-to-file audio through the
sound channel > 38 dB (tests/test_rf.py::test_wav_audio_in_out, the 16-bit
container included).
"""

import numpy as np
import pytest
import torch

from conftest import get_plan
from color_modem_tpu.utils import wav as jwav
from color_modem_tpu_torch.frame.rf import make_rf_plan, rf_demodulate_sound, rf_modulate
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils import wav as twav
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("rate_in,rate_out,n_out", [
    (48000.0, 13.5e6, None), (13.5e6, 48000.0, None), (44100.0, 13.5e6, 200000),
    (32000.0, 48000.0, 7),
])
def test_resample_linear_is_bit_equal(rate_in, rate_out, n_out):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 3, 1500)).astype(np.float32)
    got = twav.resample_linear(x, rate_in, rate_out, n_out)
    want = jwav.resample_linear(x, rate_in, rate_out, n_out)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_wav_files_round_trip(width, tmp_path):
    import wave

    rng = np.random.default_rng(width)
    x = (0.9 * rng.uniform(-1, 1, (2, 400))).astype(np.float32)
    p, q = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    twav.write_wav(p, x, 48000)
    jwav.write_wav(q, x, 48000)
    a, ra = twav.read_wav(p)
    b, rb = jwav.read_wav(q)
    assert ra == rb == 48000 and np.array_equal(a, b)
    np.testing.assert_allclose(a, x, atol=2.0 / 32767)  # truncation, 32767 vs 32768
    # other sample widths read as the JAX package reads them
    raw = rng.integers(0, 255, 2 * 100 * width, dtype=np.uint8).tobytes()
    r = str(tmp_path / f"w{width}.wav")
    with wave.open(r, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(width)
        w.setframerate(8000)
        w.writeframes(raw)
    assert np.array_equal(twav.read_wav(r)[0], jwav.read_wav(r)[0])
    twav.write_wav(p, x[0], 8000)
    assert twav.read_wav(p)[0].shape == (1, 400)


def test_a_wav_file_through_the_sound_channel(tmp_path):
    plan = plan_from_numpy(get_plan("ntsc"))
    t = np.arange(48000 // 10) / 48000.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 2500 * t)).astype(
        np.float32)
    src, rec = str(tmp_path / "tone.wav"), str(tmp_path / "rec.wav")
    twav.write_wav(src, x, 48000)
    y, rate = twav.read_wav(src)
    lines = 64
    audio = twav.resample_linear(y, rate, plan.fs, lines * plan.n_samples)
    rfp = make_rf_plan(plan)
    rf = rf_modulate(rfp, torch.zeros(1, lines, plan.n_samples), 0, torch.tensor(audio))
    got = rf_demodulate_sound(rfp, rf, 0).numpy()
    twav.write_wav(rec, twav.resample_linear(got, plan.fs, rate), rate)
    z, _ = twav.read_wav(rec)
    n = z.shape[-1]
    crop = n // 5
    a, b = z[0, crop : n - crop], x[crop : n - crop]
    assert 10 * np.log10(np.mean(b ** 2) / np.mean((a - b) ** 2)) > 38.0
