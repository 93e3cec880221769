"""The PyTorch port's WST teletext (``color_modem_tpu_torch/frame/teletext.py``)
against ``color_modem_tpu/frame/teletext.py`` on the CPU, PAL at 1440
samples (the 27 MHz grid full-rate WST needs).

Bounds: the Hamming 8/4 tables, the packet bits and every decoded field
are identical (``torch.equal`` on integers, ``==`` on the parsed packets);
the page waveforms agree to 1e-6 and the eye margins to 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from color_modem_tpu.frame import teletext as jtt
from color_modem_tpu.modem.plan import make_plan as jax_make_plan
from color_modem_tpu.standards import PAL as JPAL
from color_modem_tpu_torch.frame import teletext as tt
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

WAVE_ATOL, MARGIN_ATOL = 1e-6, 1e-5
ROWS = ["HELLO WORLD", "ROW TWO", "0123456789 abcdefghij ABCDEFGHIJ !@#$%^&*+", ""]


@pytest.fixture(scope="module")
def plans():
    jp = jax_make_plan(JPAL(), 1440)
    return jp, plan_from_numpy(jp)


def test_hamming_tables_are_identical():
    assert np.array_equal(tt._HAM84_CODE, jtt._HAM84_CODE)
    assert np.array_equal(tt._HAM84_VAL, jtt._HAM84_VAL)
    assert np.array_equal(tt._HAM84_OK, jtt._HAM84_OK)
    nib = np.arange(16)
    assert torch.equal(tt.hamming84_encode(nib),
                       torch.tensor(np.asarray(jtt.hamming84_encode(nib))))
    every_byte = (np.arange(256)[:, None] >> np.arange(8)) & 1
    val_j, ok_j = jtt.hamming84_decode(jnp.asarray(every_byte))
    val, ok = tt.hamming84_decode(torch.tensor(every_byte))
    assert torch.equal(val, torch.tensor(np.asarray(val_j)))
    assert torch.equal(ok, torch.tensor(np.asarray(ok_j)))
    # single errors correct, double errors flag
    assert int(ok.sum()) == 16 * 9


@pytest.mark.parametrize("magazine,page,subcode,header", [
    (1, 0x00, 0, "P100 PAL"), (8, 0xFF, 0x3FFF, "x" * 40), (3, 0x4A, 0x1234, ""),
])
def test_packet_bits_are_identical(magazine, page, subcode, header):
    got = tt.header_packet_bits(magazine, page, subcode, header)
    assert got.dtype == torch.int32 and got.shape == (tt.PACKET_BITS,)
    assert torch.equal(got, torch.tensor(np.asarray(
        jtt.header_packet_bits(magazine, page, subcode, header))))
    for row, text in enumerate(ROWS, start=1):
        assert torch.equal(tt.row_packet_bits(magazine, row, text), torch.tensor(
            np.asarray(jtt.row_packet_bits(magazine, row, text))))


@pytest.mark.parametrize("call", [
    lambda m: m.row_packet_bits(0, 1, "x"), lambda m: m.row_packet_bits(1, 26, "x"),
    lambda m: m.row_packet_bits(1, 1, "é"), lambda m: m.header_packet_bits(1, 0x100),
    lambda m: m.header_packet_bits(1, 1, 0x4000),
])
def test_packet_refusals_match_jax(call):
    with pytest.raises(ValueError):
        call(jtt)
    with pytest.raises(ValueError):
        call(tt)


def test_wst_needs_the_wide_grid():
    jp = jax_make_plan(JPAL(), 720)
    with pytest.raises(ValueError, match="width >= 1440"):
        tt.wst_spec(plan_from_numpy(jp))
    with pytest.raises(ValueError, match="width >= 1440"):
        jtt.wst_spec(jp)


def _same_packets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert np.array_equal(gd.pop("parity_ok"), wd.pop("parity_ok"))
        assert abs(gd.pop("margin") - wd.pop("margin")) <= MARGIN_ATOL
        assert gd == wd


@pytest.mark.parametrize("gain,sigma,flip", [(1.0, 0.0, False), (0.85, 0.03, False),
                                             (1.0, 0.0, True)])
def test_page_matches_jax(plans, gain, sigma, flip):
    jp, tp = plans
    wave_j = np.asarray(jtt.encode_page(jp, 5, 0x37, ROWS, header="P537 TEST"))
    wave = tt.encode_page(tp, 5, 0x37, ROWS, header="P537 TEST", device="cpu")
    assert wave.shape == (1 + len(ROWS), 1440)
    np.testing.assert_allclose(wave.numpy(), wave_j, rtol=0, atol=WAVE_ATOL)
    line = (gain * wave_j + np.random.default_rng(4).normal(0.0, sigma, wave_j.shape)
            ).astype(np.float32)
    if flip:
        # a burst of wrong level over one address byte and a few characters:
        # the Hamming and parity flags must report what JAX reports
        spb = jp.fs / (444.0 * jp.cfg.fh)
        start = int(16 * spb + 8 * spb)
        line[1, start : start + int(24 * spb)] = 0.66 - line[1, start : start + int(24 * spb)]
    want = jtt.decode_packets(jp, jnp.asarray(line))
    got = tt.decode_packets(tp, torch.tensor(line))
    _same_packets(got, want)
    assert tt.render_page(got) == jtt.render_page(want)
    if not flip:
        shown = [r[: tt.ROW_CHARS].rstrip() for r in ROWS]
        assert tt.render_page(got) == "\n".join(["P537 TEST"] + shown).rstrip()
        assert got[0].page == 0x37 and got[0].magazine == 5 and got[0].header_ok


def test_render_page_orders_and_blanks_rows():
    pkt = lambda p, text: tt.TeletextPacket(1, p, True, text, np.ones(1, bool))  # noqa: E731
    jpkt = lambda p, text: jtt.TeletextPacket(1, p, True, text, np.ones(1, bool))  # noqa: E731
    order = [(3, "C  "), (0, "HEAD "), (1, "A")]
    assert tt.render_page([pkt(*o) for o in order]) == jtt.render_page([jpkt(*o) for o in order])
    assert tt.render_page([pkt(0, "ONLY")]) == "ONLY"
