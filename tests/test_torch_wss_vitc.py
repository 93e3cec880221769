"""The PyTorch port's WSS (``frame/wss.py``) and VITC (``frame/vitc.py``)
against the JAX package's on the CPU.

Bounds: the aspect codebook, the status words, the VITC words and their
CRC-8 are identical; the waveforms agree to 1e-6; every decoded bit, the
VITC sync score and the chosen clock phase equal JAX's (``torch.equal``),
and the WSS margins agree to 1e-5.  VITC's 24 candidate phases tie often;
the phase kept is the first best, as ``jnp.argmax`` keeps it, and a test
runs lines whose tied phases slice different bits.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from color_modem_tpu.frame import vitc as jvt
from color_modem_tpu.frame import wss as jw
from color_modem_tpu.modem.plan import make_plan as jax_make_plan
from color_modem_tpu.standards import NTSC as JNTSC
from color_modem_tpu.standards import PAL as JPAL
from color_modem_tpu_torch.frame import vitc as tvt
from color_modem_tpu_torch.frame import wss as tw
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

WAVE_ATOL, MARGIN_ATOL = 1e-6, 1e-5
GRIDS = [("pal", 720), ("pal", 1440), ("ntsc", 720), ("ntsc", 960)]
_PLANS = {}


def plans(name, n):
    if (name, n) not in _PLANS:
        jp = jax_make_plan({"ntsc": JNTSC, "pal": JPAL}[name](), n)
        _PLANS[name, n] = (jp, plan_from_numpy(jp))
    return _PLANS[name, n]


def _channel(wave, rng, delay, gain, sigma):
    return (gain * np.roll(wave, delay, axis=-1)
            + rng.normal(0.0, sigma, wave.shape)).astype(np.float32)


# --- WSS -------------------------------------------------------------------------

def test_wss_words_are_identical():
    assert tw.ASPECT_CODES == jw.ASPECT_CODES and tw.GROUPS == jw.GROUPS
    assert tw._START == jw._START and tw.LEVEL == jw.LEVEL
    for aspect in jw.ASPECT_CODES:
        for groups in ((0, 0, 0), (15, 7, 7), (5, 2, 6)):
            got = tw.wss_word(aspect, *groups)
            assert got.dtype == torch.int32
            assert torch.equal(got, torch.tensor(np.asarray(jw.wss_word(aspect, *groups))))
            assert tw.parse_wss(got) == jw.parse_wss(got.numpy())
    with pytest.raises(ValueError, match="unknown aspect"):
        tw.wss_word("4:3")
    with pytest.raises(ValueError, match="exceeds 3 bits"):
        tw.wss_word("4:3 full", 0, 8)
    broken = tw.wss_word("4:3 full").clone()
    broken[1] ^= 1  # an even-weight aspect group fails the codebook check
    assert tw.parse_wss(broken) == jw.parse_wss(broken.numpy())
    assert tw.parse_wss(broken)["aspect_ok"] is False


@pytest.mark.parametrize("name,n", GRIDS[:3])
def test_wss_line_matches_jax(name, n):
    jp, tp = plans(name, n)
    assert tw.wss_layout(tp) == tw.WssLayout(**vars(jw.wss_layout(jp)))
    words = np.stack([np.asarray(jw.wss_word(a, k % 16, k % 8, (3 * k) % 8))
                      for k, a in enumerate(jw.ASPECT_CODES)])
    wave_j = np.asarray(jw.encode_wss(jp, jnp.asarray(words)))
    wave = tw.encode_wss(tp, torch.tensor(words))
    np.testing.assert_allclose(wave.numpy(), wave_j, rtol=0, atol=WAVE_ATOL)
    rng = np.random.default_rng(n)
    for delay, gain, sigma in ((0, 1.0, 0.0), (1, 0.7, 0.05), (-2, 1.3, 0.08)):
        line = _channel(wave_j, rng, delay, gain, sigma)
        bits_j, margin_j = jw.decode_wss(jp, jnp.asarray(line))
        bits, margin = tw.decode_wss(tp, torch.tensor(line))
        assert torch.equal(bits, torch.tensor(np.asarray(bits_j))), (delay, gain, sigma)
        assert torch.equal(bits, torch.tensor(words))
        np.testing.assert_allclose(margin.numpy(), np.asarray(margin_j), rtol=0,
                                   atol=MARGIN_ATOL)


def test_wss_refusals_match_jax():
    jp, tp = plans("pal", 720)
    with pytest.raises(ValueError, match="carries 14 bits"):
        tw.encode_wss(tp, torch.zeros(13, dtype=torch.int32))
    narrow = jax_make_plan(JNTSC(), 500)  # 9.4 MHz: under 2 samples per element
    for mod, p in ((jw, narrow), (tw, plan_from_numpy(narrow))):
        with pytest.raises(ValueError, match="samples/element"):
            mod.wss_layout(p)


# --- VITC ------------------------------------------------------------------------

def test_vitc_words_and_crc_are_identical():
    rng = np.random.default_rng(0)
    for _ in range(64):
        bits = rng.integers(0, 2, 82)
        assert np.array_equal(tvt._crc8(bits), jvt._crc8(bits))
    for n in (0, 1, 24, 977, 25 * 3600 * 24 - 1, 12345678):
        tc = tvt.timecode_for_frame(n)
        assert tc == jvt.timecode_for_frame(n) and tvt.timecode_for_frame(n, 30) == \
            jvt.timecode_for_frame(n, 30)
        for kw in ({}, {"drop_frame": True, "field": True, "user": tuple(range(8))}):
            word = tvt.vitc_pack(*tc, **kw)
            assert np.array_equal(word, jvt.vitc_pack(*tc, **kw))
            assert tvt.vitc_unpack(torch.tensor(word)) == jvt.vitc_unpack(word)
    word = tvt.vitc_pack(1, 2, 3, 4)
    word[40] ^= 1
    assert tvt.vitc_unpack(word) == jvt.vitc_unpack(word)
    assert tvt.vitc_unpack(word)["crc_ok"] is False
    with pytest.raises(ValueError, match="bad timecode"):
        tvt.vitc_pack(24, 0, 0, 0)


@pytest.mark.parametrize("name,n", GRIDS)
def test_vitc_phase_grid_is_jax_s(name, n):
    """The 24 phases' integrate-and-dump indices equal the ones the JAX
    decoder computes in float32 (``jnp.linspace``, rounded half to even)."""
    jp, tp = plans(name, n)
    spb, guard = jvt._geometry(jp)
    taus = jnp.linspace(-0.5 * spb, 0.5 * spb, 24)
    centers = (guard + (jnp.arange(90, dtype=jnp.float32) + 0.5) * spb)[None, :] + taus[:, None]
    offs = jnp.arange(-np.floor(0.3 * spb), np.floor(0.3 * spb) + 1.0, dtype=jnp.float32)
    idx = jnp.clip(jnp.round(centers[..., None] + offs).astype(jnp.int32), 0, jp.n_samples - 1)
    assert np.array_equal(tvt._phase_grid(tp.cfg.fh, tp.fs, tp.n_samples, 24), np.asarray(idx))


def _jax_phase_bits(jp, line):
    """Per-phase bits and scores of the JAX decoder, step by step."""
    spb, guard = jvt._geometry(jp)
    taus = jnp.linspace(-0.5 * spb, 0.5 * spb, 24)
    centers = (guard + (jnp.arange(90, dtype=jnp.float32) + 0.5) * spb)[None, :] + taus[:, None]
    offs = jnp.arange(-np.floor(0.3 * spb), np.floor(0.3 * spb) + 1.0, dtype=jnp.float32)
    idx = jnp.clip(jnp.round(centers[..., None] + offs).astype(jnp.int32), 0, jp.n_samples - 1)
    vals = jnp.mean(jnp.asarray(line)[..., idx], axis=-1)
    hi = jnp.mean(vals[..., jnp.asarray(jvt.SYNC_ONES)], axis=-1, keepdims=True)
    lo = jnp.mean(vals[..., jnp.asarray(jvt.SYNC_ZEROS)], axis=-1, keepdims=True)
    bits_p = np.asarray((vals > 0.5 * (hi + lo)).astype(jnp.int32))
    score = (bits_p[..., list(jvt.SYNC_ONES)].sum(-1)
             + (1 - bits_p[..., list(jvt.SYNC_ZEROS)]).sum(-1))
    return bits_p, score


@pytest.mark.parametrize("name,n", GRIDS)
def test_vitc_line_matches_jax(name, n):
    jp, tp = plans(name, n)
    words = np.stack([jvt.vitc_pack(*jvt.timecode_for_frame(977 * k), user=tuple(range(8)))
                      for k in range(6)])
    wave_j = np.asarray(jvt.encode_vitc_line(jp, jnp.asarray(words)))
    wave = tvt.encode_vitc_line(tp, torch.tensor(words))
    np.testing.assert_allclose(wave.numpy(), wave_j, rtol=0, atol=WAVE_ATOL)
    rng = np.random.default_rng(n + 7)
    for delay, gain, sigma in ((0, 1.0, 0.0), (2, 0.6, 0.08), (-3, 1.3, 0.15)):
        line = _channel(wave_j, rng, delay, gain, sigma)
        bits_j, score_j = jvt.decode_vitc_line(jp, jnp.asarray(line))
        bits, score = tvt.decode_vitc_line(tp, torch.tensor(line))
        assert torch.equal(bits, torch.tensor(np.asarray(bits_j))), (delay, gain, sigma)
        assert torch.equal(score, torch.tensor(np.asarray(score_j)))
        if sigma == 0.0:
            assert torch.equal(bits.to(torch.int64), torch.tensor(words))


def test_vitc_tied_phases_keep_the_first():
    """Noisy lines on which several phases reach the best sync score and
    slice the payload differently: the port keeps the first of them, as
    ``jnp.argmax`` does, and so decodes JAX's bits."""
    jp, tp = plans("pal", 720)
    words = np.stack([jvt.vitc_pack(*jvt.timecode_for_frame(131 * k)) for k in range(32)])
    wave = np.asarray(jvt.encode_vitc_line(jp, jnp.asarray(words)))
    line = _channel(wave, np.random.default_rng(11), 1, 1.0, 0.3)
    bits_p, score = _jax_phase_bits(jp, line)
    best = score.max(-1, keepdims=True)
    tied = score == best
    first = np.argmax(score, axis=-1)
    differ = [r for r in range(len(line)) if tied[r].sum() > 1 and any(
        not np.array_equal(bits_p[r, p], bits_p[r, first[r]]) for p in np.nonzero(tied[r])[0])]
    assert len(differ) >= 3, differ  # the case under test occurs on this input
    bits_j, score_j = jvt.decode_vitc_line(jp, jnp.asarray(line))
    bits, got_score = tvt.decode_vitc_line(tp, torch.tensor(line))
    assert torch.equal(bits, torch.tensor(np.asarray(bits_j)))
    assert torch.equal(got_score, torch.tensor(np.asarray(score_j)))
    assert np.array_equal(bits.numpy(), bits_p[np.arange(len(line)), first])
