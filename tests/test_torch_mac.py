"""The port's D2-MAC modem (``color_modem_tpu_torch/modem/mac.py`` and
``mac_plan.py``) against the JAX package and the frozen oracle
``golden/mac.py``, on the CPU.

Bounds: the plan's arrays bit-identical; encode and decode within 1e-5 of
JAX (max abs; the resampling products are float32 either side); >= 60 dB
against golden (tests/test_mac.py); the smooth-scene round trip at
tests/test_mac.py's 49.5 dB; a clean channel decodes the burst with no bit
error and the sync word on every line.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from color_modem_tpu.golden import mac as gmac
from color_modem_tpu.modem import mac as jmac
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.modem import mac as tmac
from color_modem_tpu_torch.utils.metrics import psnr
from torch_threads import one_torch_thread  # noqa: F401

L, W = 48, 720
VARIANTS = ("d2", "d")


def _cap(plan):
    return plan.cfg.data_symbols - len(plan.cfg.line_sync_word)


@pytest.fixture(scope="module")
def img():
    return smooth_scene(L, W, seed=9).astype(np.float32)


@pytest.fixture(scope="module")
def gline():
    return np.arange(L)


@pytest.mark.parametrize("variant", VARIANTS)
def test_plan_is_bit_identical(variant):
    jp, tp = jmac.make_mac_plan(W, variant), tmac.make_mac_plan(W, variant)
    assert tp.cfg == tmac.MacConfig(**vars(jp.cfg)) and tp.width == jp.width
    for name in ("rgb_to_ycc", "ycc_to_rgb", "halfband"):
        a, b = getattr(tp, name), getattr(jp, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert tmac.make_mac_plan(W, variant) is tp  # cached like the JAX plan
    assert tmac.sound_capacity(tp, 576) == jmac.sound_capacity(jp, 576)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown MAC variant"):
        tmac.make_mac_plan(W, "c")


def test_duobinary_round_trip():
    bits = np.random.default_rng(2).integers(0, 2, size=(16, 105))
    d = tmac.duobinary_levels(torch.tensor(bits))
    assert torch.all((d == 0) | (d == 1) | (d == -1))
    assert torch.equal(tmac.duobinary_bits(d), torch.tensor(bits, dtype=torch.int32))
    assert torch.all(torch.abs(torch.diff(d, dim=-1)) <= 1)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jmac.duobinary_levels(jnp.asarray(bits))))


@pytest.mark.parametrize("variant", VARIANTS)
def test_encode_decode_match_jax_and_golden(variant, img, gline):
    jp, tp = jmac.make_mac_plan(W, variant), tmac.make_mac_plan(W, variant)
    payload = np.random.default_rng(0).integers(0, 2, size=(L, _cap(tp)))
    t_sig = tmac.encode(tp, torch.tensor(img), torch.tensor(gline), torch.tensor(payload))
    j_sig = np.asarray(jmac.encode(jp, jnp.asarray(img), jnp.asarray(gline),
                                   jnp.asarray(payload, jnp.int32)))
    assert t_sig.shape == (L, 1296) and t_sig.dtype == torch.float32
    np.testing.assert_allclose(t_sig.numpy(), j_sig, rtol=0, atol=1e-5)
    t_rgb = tmac.decode(tp, torch.tensor(j_sig), torch.tensor(gline))
    j_rgb = np.asarray(jmac.decode(jp, jnp.asarray(j_sig), jnp.asarray(gline)))
    np.testing.assert_allclose(t_rgb.numpy(), j_rgb, rtol=0, atol=1e-5)
    g_sig = gmac.encode_frame(tp, img, 0, payload=list(payload))
    assert psnr(t_sig, torch.tensor(g_sig)) >= 60.0
    g_rgb = gmac.decode_frame(tp, g_sig, 0)
    assert psnr(tmac.decode(tp, torch.tensor(g_sig, dtype=torch.float32),
                            torch.tensor(gline)), torch.tensor(g_rgb)) >= 60.0
    ok, bits = gmac.decode_data_line(tp, t_sig[3].numpy().astype(np.float64))
    assert ok and list(bits) == list(payload[3])


def test_round_trip_bound(img, gline):
    tp = tmac.make_mac_plan(W)
    x = torch.tensor(smooth_scene(L, W, seed=3).astype(np.float32))
    assert psnr(tmac.roundtrip(tp, x, torch.tensor(gline)), x) >= 49.5
    out = tmac.roundtrip(tp, torch.tensor(img)[None], torch.tensor(gline)[None])
    assert out.shape == (1, 3, L, W)


@pytest.mark.parametrize("variant", VARIANTS)
def test_clean_channel_decodes_every_bit(variant, img, gline):
    tp = tmac.make_mac_plan(W, variant)
    payload = torch.tensor(np.random.default_rng(5).integers(0, 2, size=(L, _cap(tp))))
    sig = tmac.encode(tp, torch.tensor(img), torch.tensor(gline), payload)
    ok, bits = tmac.decode_data(tp, sig)
    assert bool(ok.all()) and torch.equal(bits, payload.to(torch.int32))
    # symbol centres pass the half-band shaper exactly; sigma 0.03 leaves a
    # decision margin of ~6.7 sigma
    gen = torch.Generator().manual_seed(7)
    ok_n, bits_n = tmac.decode_data(tp, sig + 0.03 * torch.randn(sig.shape, generator=gen))
    assert bool(ok_n.all()) and torch.equal(bits_n, payload.to(torch.int32))


def test_no_payload_sends_the_sync_word(img, gline):
    tp = tmac.make_mac_plan(W)
    sig = tmac.encode(tp, torch.tensor(img), torch.tensor(gline))
    ok, bits = tmac.decode_data(tp, sig)
    assert bool(ok.all()) and not bits.any()
    with pytest.raises(ValueError, match="capacity"):
        tmac.encode(tp, torch.tensor(img), torch.tensor(gline),
                    torch.zeros(L, _cap(tp) + 1, dtype=torch.int32))


def test_line_sequential_parity():
    tp = tmac.make_mac_plan(W)
    g = torch.arange(8)
    ycc = torch.stack([torch.full((8, W), 0.5), torch.full((8, W), 0.3), torch.zeros(8, W)])
    rgb = torch.einsum("ij,jlw->ilw", torch.tensor(tp.ycc_to_rgb, dtype=torch.float32), ycc)
    sig = tmac.encode(tp, rgb, g)
    cfg = tp.cfg
    dev = torch.abs(sig[..., cfg.chroma_start : cfg.chroma_start + cfg.chroma_len]
                    - cfg.pedestal).amax(dim=-1)
    assert bool(torch.all(dev[0::2] > 0.1)), "even lines must carry U"
    assert bool(torch.all(dev[1::2] < 1e-3)), "odd lines must rest (V = 0)"


def test_clamp_removes_a_line_dc_offset(img, gline):
    tp = tmac.make_mac_plan(W)
    sig = tmac.encode(tp, torch.tensor(img), torch.tensor(gline))
    offset = torch.linspace(-0.1, 0.1, L)[:, None]
    a = tmac.decode(tp, sig, torch.tensor(gline))
    b = tmac.decode(tp, sig + offset, torch.tensor(gline))
    torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


def test_dmac_variant_doubles_the_payload_with_the_same_picture(img, gline):
    d2, dm = tmac.make_mac_plan(W, "d2"), tmac.make_mac_plan(W, "d")
    assert dm.cfg.samples_per_symbol == 1 and _cap(dm) == 204 and _cap(d2) == 99
    x, g = torch.tensor(img), torch.tensor(gline)
    torch.testing.assert_close(tmac.roundtrip(d2, x, g), tmac.roundtrip(dm, x, g),
                               rtol=0, atol=0)
    payload = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(1), 0.5, (L, 204)), np.int32)
    ok, bits = tmac.decode_data(dm, tmac.encode(dm, x, g, torch.tensor(payload)))
    assert bool(ok.all()) and np.array_equal(bits.numpy(), payload)


# --- packet sound, and the burst bits' device -----------------------------------


def _stereo(n, seed=None):
    if seed is None:
        t = np.arange(n) / 32000.0
        return ((0.7 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
                (0.5 * np.sin(2 * np.pi * 997 * t)).astype(np.float32))
    rng = np.random.default_rng(seed)
    return tuple((0.5 * rng.standard_normal(n)).clip(-1, 1).astype(np.float32)
                 for _ in range(2))


def _snr_db(got, want):
    return -10.0 * np.log10(float(np.mean((np.asarray(got) - want) ** 2)) + 1e-12)


def test_packet_sound_matches_jax_bit_for_bit():
    """pack_sound's payload and unpack_sound's audio and report equal the
    JAX package's; the clean burst carries the audio at the NICAM
    companding floor (>= 55 dB, tests/test_mac.py)."""
    tp, jp = tmac.make_mac_plan(W), jmac.make_mac_plan(W)
    n_lines = 576
    cap = tmac.sound_capacity(tp, n_lines)
    assert cap == jmac.sound_capacity(jp, n_lines) and cap >= 78
    left, right = _stereo(cap * 32)
    payload, n_f = tmac.pack_sound(tp, torch.tensor(left), torch.tensor(right), n_lines)
    j_payload, j_nf = jmac.pack_sound(jp, jnp.asarray(left), jnp.asarray(right), n_lines)
    assert n_f == j_nf == cap and payload.shape == (n_lines, _cap(tp))
    assert torch.equal(payload, torch.tensor(np.asarray(j_payload)))
    img = torch.tensor(smooth_scene(n_lines, W, seed=2).astype(np.float32))
    ok, bits = tmac.decode_data(tp, tmac.encode(tp, img, torch.arange(n_lines), payload))
    assert bool(ok.all()) and torch.equal(bits, payload)
    gl, gr, rep = tmac.unpack_sound(tp, bits, n_f)
    jl, jr, jrep = jmac.unpack_sound(jp, jnp.asarray(bits.numpy()), n_f)
    assert torch.equal(gl, torch.tensor(np.asarray(jl)))
    assert torch.equal(gr, torch.tensor(np.asarray(jr)))
    assert int(rep["parity_errors"].sum()) == 0
    assert _snr_db(gl, left) >= 55.0 and _snr_db(gr, right) >= 55.0
    with pytest.raises(ValueError, match="NICAM frames need"):
        tmac.pack_sound(tp, torch.tensor(left), torch.tensor(right), n_lines // 2)


def test_packet_sound_survives_satellite():
    """Picture and packet sound through the FM satellite hop at CNR 20 with
    energy dispersal: zero parity errors, audio >= 50 dB."""
    from color_modem_tpu_torch.frame import satellite as tsat
    from color_modem_tpu_torch.utils import prng

    tp = tmac.make_mac_plan(W)
    n_lines = 64
    left, right = _stereo(tmac.sound_capacity(tp, n_lines) * 32, seed=3)
    payload, n_f = tmac.pack_sound(tp, torch.tensor(left), torch.tensor(right), n_lines)
    g = torch.arange(n_lines)
    img = torch.tensor(smooth_scene(n_lines, W, seed=4).astype(np.float32))
    sig = tmac.encode(tp, img, g, payload)
    sp = tsat.make_sat_plan(tp.cfg.fs, tp.cfg.samples_per_line, dispersal=0.1)
    rx = tsat.sat_roundtrip(sp, sig[None], gline=g[None], key=prng.PRNGKey(9),
                            cnr_db=20.0)[0]
    ok, bits = tmac.decode_data(tp, rx)
    assert bool(ok.all())
    gl, _, rep = tmac.unpack_sound(tp, bits, n_f)
    assert int(rep["parity_errors"].sum()) == 0 and _snr_db(gl, left) >= 50.0


def test_line_bits_follow_the_payload():
    """line_bits puts the bits where the payload lies (a meta-device payload
    stays there), and with neither a payload nor a device defaults to the
    card, which raises without CUDA as the factories do."""
    tp = tmac.make_mac_plan(W)
    meta = torch.zeros(3, 4, 10, dtype=torch.int32, device="meta")
    out = tmac.line_bits(tp, meta, (3, 4))
    assert out.device.type == "meta" and out.shape == (3, 4, tp.cfg.data_symbols)
    cpu = tmac.line_bits(tp, torch.ones(4, 10, dtype=torch.int32), (4,))
    assert cpu.device.type == "cpu" and int(cpu[:, -1].sum()) == 0
    assert tmac.line_bits(tp, None, (4,), "cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmac.line_bits(tp, None, (4,))
