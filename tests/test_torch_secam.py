"""The PyTorch port's SECAM FM path against the JAX package, on the CPU.

* the plain modem (``modem/secam.py``, ``separate/delayline.py``) against
  the JAX ``xla`` functions;
* the kernel wrappers (``kernels/secam.py``), which run their plain versions
  on CPU tensors, against the JAX Pallas kernels in interpret mode, as
  tests/test_kernels.py runs them; the launch counters stay 0;
* the slice whole, ``make_pipeline`` with notch/avg/interp on both
  backends, against the JAX pipeline, the golden oracle and the
  tests/test_roundtrip.py round-trip bounds; the 1440-sample plan;
* line identification, held to the tests/test_secam_ident.py decisions.

Bounds: encode 2e-4 (tests/test_kernels.py's SECAM bound: the scan order
differs from XLA's cumsum), extend_blanking 1e-6, decode 5e-4, golden
>= 60 dB.  Inputs come from numpy with a seed: B=2 frames of 32 lines x 720
samples, an odd first frame.  The luma of every decode input is smooth
(``smooth_scene``): wideband random luma leaks into the chroma takeoff.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import TEST_SAMPLES, get_plan
from color_modem_tpu import golden
from color_modem_tpu.frame.pipeline import decode_block as jax_decode_block
from color_modem_tpu.frame.pipeline import encode_block as jax_encode_block
from color_modem_tpu.frame.pipeline import frame_line_index as jax_frame_line_index
from color_modem_tpu.frame.pipeline import make_pipeline as jax_make_pipeline
from color_modem_tpu.kernels import secam as jax_sk
from color_modem_tpu.modem import secam as jax_secam
from color_modem_tpu.modem.plan import make_plan as jax_make_plan
from color_modem_tpu.separate import delayline as jax_delayline
from color_modem_tpu.standards import SECAM
from color_modem_tpu.utils.metrics import psnr as np_psnr
from color_modem_tpu.utils.testimages import color_bars, smooth_scene
from color_modem_tpu_torch.frame.pipeline import decode_block, encode_block, make_pipeline
from color_modem_tpu_torch.kernels import launch_counts, reset_launches
from color_modem_tpu_torch.kernels import secam as sk
from color_modem_tpu_torch.modem import secam
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.separate.delayline import average_with_neighbor
from torch_threads import one_torch_thread  # noqa: F401

B, L, N = 2, 32, TEST_SAMPLES
FRAME0 = 3
ENC_ATOL, DEC_ATOL, EXT_ATOL = 2e-4, 5e-4, 1e-6
DECODERS = ["notch", "avg", "interp"]
#: tests/test_roundtrip.py's SECAM round-trip bounds, 64x720 fixture
ROUNDTRIP_BOUNDS = {"notch": 33.5, "avg": 31.5, "interp": 37.0}

_PLANS = {}


def plans(n=N):
    """(JAX ModemPlan, port FmPlan) carrying the same parameters."""
    if n not in _PLANS:
        jp = get_plan("secam") if n == N else jax_make_plan(SECAM(), n)
        _PLANS[n] = (jp, plan_from_numpy(jp))
    return _PLANS[n]


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def glines(jp, frames=B, lines=L, frame0=FRAME0):
    return np.asarray(jax_frame_line_index(jp, frame0, frames, lines))


def rgb_input(frames=B, lines=L, n=N):
    return np.stack([smooth_scene(lines, n, seed=s) for s in range(1, frames + 1)]
                    ).astype(np.float32)


def ycc_input(lines=L, seed=0):
    """Smooth luma, random D'R/D'B."""
    rng = np.random.default_rng(seed)
    y = rgb_input(lines=lines)[:, 1]
    return np.stack([y, rng.uniform(-0.6, 0.6, y.shape), rng.uniform(-0.6, 0.6, y.shape)],
                    axis=1).astype(np.float32)


def composite(lines=L):
    """The JAX xla composite of the smooth scene: (B, lines, N)."""
    jp, _ = plans()
    g = glines(jp, lines=lines)
    return np.asarray(jax_encode_block(jp, jnp.asarray(rgb_input(lines=lines)),
                                       jnp.asarray(g), "xla")), g


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    reset_launches()
    yield
    assert set(launch_counts().values()) == {0}


# --- plain modem vs the JAX xla functions -----------------------------------


def test_plain_encode_matches_jax():
    jp, tp = plans()
    ycc, g = ycc_input(), glines(jp)
    ref = np.asarray(jax_secam.encode(jp, jnp.asarray(ycc), jnp.asarray(g)))
    got = secam.encode(tp, t(ycc), t(g)).numpy()
    np.testing.assert_allclose(got, ref, atol=ENC_ATOL)


def test_extend_blanking_matches_jax():
    jp, tp = plans()
    comp, g = composite()
    ref = np.asarray(jax_secam.extend_blanking(jp, jnp.asarray(comp), jnp.asarray(g)))
    got = secam.extend_blanking(tp, t(comp), t(g)).numpy()
    assert got.shape == (B, L, N + 2 * tp.fm_margin)
    np.testing.assert_allclose(got, ref, atol=EXT_ATOL)


def test_plain_demodulate_matches_jax():
    jp, tp = plans()
    comp, g = composite()
    ref = jax_secam.demodulate_lines(jp, jnp.asarray(comp), jnp.asarray(g))
    got = secam.demodulate_lines(tp, t(comp), t(g))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=DEC_ATOL)


@pytest.mark.parametrize("pairing", ["copy", "interp"])
def test_plain_decode_matches_jax(pairing):
    jp, tp = plans()
    comp, g = composite()
    ref = np.asarray(jax_secam.decode(jp, jnp.asarray(comp), jnp.asarray(g), pairing))
    got = secam.decode(tp, t(comp), t(g), pairing).numpy()
    assert got.shape == (B, 3, L, N)
    np.testing.assert_allclose(got, ref, atol=DEC_ATOL)


@pytest.mark.parametrize("pairing", ["copy", "interp"])
def test_pairing_bit_equal(pairing):
    jp, _ = plans()
    v = np.random.default_rng(4).normal(size=(B, 9, 16)).astype(np.float32)
    g = glines(jp, lines=9)
    fn = {"copy": jax_secam.pair_components,
          "interp": jax_secam.pair_components_interp}[pairing]
    ref = fn(jnp.asarray(v), jnp.asarray(g))
    got = secam.pair(t(v), t(g), pairing)
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_average_with_neighbor_bit_equal():
    x = np.random.default_rng(6).normal(size=(B, 2, 9, 16)).astype(np.float32)
    ref = np.asarray(jax_delayline.average_with_neighbor(jnp.asarray(x)))
    assert np.array_equal(average_with_neighbor(t(x)).numpy(), ref)


# --- kernel wrappers vs the JAX Pallas kernels ------------------------------


@pytest.mark.parametrize("lines", [L, 27])
def test_kernel_encode_matches_pallas(lines):
    jp, tp = plans()
    ycc, g = ycc_input(lines), glines(jp, lines=lines)
    ref = np.asarray(jax_sk.encode(jp, jnp.asarray(ycc), jnp.asarray(g)))
    got = sk.encode(tp, t(ycc), t(g)).numpy()
    assert got.shape == (B, lines, N)
    np.testing.assert_allclose(got, ref, atol=ENC_ATOL)


@pytest.mark.parametrize("decoder", DECODERS)
def test_kernel_decode_block_matches_pallas(decoder):
    jp, tp = plans()
    comp, g = composite()
    ref = np.asarray(jax_decode_block(jp, jnp.asarray(comp), jnp.asarray(g), decoder,
                                      "pallas"))
    got = decode_block(tp, t(comp), t(g), decoder, "kernel").numpy()
    np.testing.assert_allclose(got, ref, atol=DEC_ATOL)


def test_kernel_demodulate_odd_line_count_matches_pallas():
    jp, tp = plans()
    comp, g = composite(lines=27)
    ref = jax_sk.demodulate_lines(jp, jnp.asarray(comp), jnp.asarray(g))
    got = sk.demodulate(tp, t(comp), t(g))
    for a, b in zip(got, ref):
        assert a.shape == (B, 27, N)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=DEC_ATOL)


def test_lines_plain_match_modem_twins():
    """The kernels' plain versions (host-built mix rows, the kernel's
    discriminator form) agree with the modem twins on the port itself."""
    jp, tp = plans()
    ycc, g = t(ycc_input()), t(glines(jp))
    np.testing.assert_allclose(sk.encode(tp, ycc, g).numpy(),
                               secam.encode(tp, ycc, g).numpy(), atol=ENC_ATOL)
    comp, g = composite()
    got = sk.demodulate(tp, t(comp), t(g))
    ref = secam.demodulate_lines(tp, t(comp), t(g))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=DEC_ATOL)


def test_isr_col_marks_odd_lines():
    jp, _ = plans()
    g = glines(jp)
    col = sk.isr_col(t(g))
    assert col.dtype == torch.float32 and col.shape == (B * L,)
    assert np.array_equal(col.numpy(), (g.reshape(-1) % 2).astype(np.float32))
    # total_lines = 625 is odd: the parity of line 0 flips every frame
    assert col[0] != col[L]


def test_wrappers_check_their_inputs():
    _, tp = plans()
    ycc = torch.zeros((1, 3, 4, N))
    isr = torch.zeros(4)
    with pytest.raises(TypeError):
        sk.encode_lines(tp, ycc.double(), isr)
    with pytest.raises(ValueError, match="contiguous"):
        sk.encode_lines(tp, ycc.transpose(2, 3).contiguous().transpose(2, 3), isr)
    with pytest.raises(ValueError, match="samples per line"):
        sk.demodulate_lines(tp, torch.zeros((1, 4, N - 1)), isr)
    with pytest.raises(ValueError, match="isr"):
        sk.encode_lines(tp, ycc, isr[:3])
    with pytest.raises(ValueError, match="plan is on"):
        sk.encode_lines(tp, ycc.to("meta"), isr.to("meta"))
    meta = plan_from_numpy(get_plan("secam")).to("meta")
    with pytest.raises(ValueError, match="no SECAM kernel"):
        sk.demodulate_lines(meta, torch.zeros((1, 4, N), device="meta"),
                            torch.zeros(4, device="meta"))


# --- the slice whole --------------------------------------------------------


_JAX_OUT = {}


def jax_outputs(decoder, rgb):
    """(composite, round-trip RGB) of the JAX xla pipeline at FRAME0."""
    if decoder not in _JAX_OUT:
        enc, _, rt = jax_make_pipeline(plans()[0], decoder, "xla")
        x = jnp.asarray(rgb)
        _JAX_OUT[decoder] = (np.asarray(enc(x, FRAME0)), np.asarray(rt(x, FRAME0)))
    return _JAX_OUT[decoder]


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("decoder", DECODERS)
def test_slice_matches_jax_xla(decoder, backend):
    rgb = rgb_input()
    comp_j, out_j = jax_outputs(decoder, rgb)
    enc, dec, rt = make_pipeline(plans()[1], decoder, backend, device="cpu")
    comp = enc(rgb, FRAME0)
    np.testing.assert_allclose(comp.numpy(), comp_j, atol=ENC_ATOL)
    out = rt(rgb, FRAME0)
    np.testing.assert_allclose(out.numpy(), out_j, atol=DEC_ATOL)
    assert torch.equal(dec(comp, FRAME0), out)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("decoder", DECODERS)
def test_golden_parity_and_roundtrip_bounds(decoder, backend, scene):
    """On tests/test_roundtrip.py's 64x720 fixture at frame 0: >= 60 dB
    against the golden oracle, and its round-trip bound."""
    jp, tp = plans()
    enc, dec, _ = make_pipeline(tp, decoder, backend, device="cpu")
    comp = enc(scene[None], 0)
    out = dec(comp, 0).numpy()[0]
    comp_g = golden.encode_frame(jp, scene, frame=0)
    rgb_g = golden.decode_frame(jp, comp.numpy()[0], frame=0, decoder=decoder)
    assert np_psnr(comp.numpy()[0], comp_g) >= 60.0, "encode parity vs golden"
    assert np_psnr(out, rgb_g) >= 60.0, "decode parity vs golden"
    assert np_psnr(out, scene) >= ROUNDTRIP_BOUNDS[decoder]


@pytest.mark.parametrize("decoder", ["notch", "interp"])
def test_plan_1440_matches_jax(decoder):
    jp, tp = plans(1440)
    rgb = rgb_input(frames=1, lines=8, n=1440)
    enc_j, _, rt_j = jax_make_pipeline(jp, decoder, "xla")
    enc, _, rt = make_pipeline(tp, decoder, "plain", device="cpu")
    np.testing.assert_allclose(enc(rgb, FRAME0).numpy(),
                               np.asarray(enc_j(jnp.asarray(rgb), FRAME0)), atol=ENC_ATOL)
    np.testing.assert_allclose(rt(rgb, FRAME0).numpy(),
                               np.asarray(rt_j(jnp.asarray(rgb), FRAME0)), atol=DEC_ATOL)


def test_fm_rejects_qam_hooks():
    _, tp = plans()
    g = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="QAM standards only"):
        decode_block(tp, torch.zeros((1, 4, N)), g, "notch",
                     phase_err=torch.zeros((1, 4)))
    with pytest.raises(ValueError, match="supports decoders"):
        make_pipeline(tp, "comb3", device="cpu")


# --- line identification (tests/test_secam_ident.py decisions) -------------


IDENT_L = 64


@pytest.fixture(scope="module")
def ident_setup():
    jp, tp = plans()
    rgb = smooth_scene(IDENT_L, N, seed=5).astype(np.float32)[None]
    g = t(glines(jp, frames=1, lines=IDENT_L, frame0=0))
    comp = encode_block(tp, torch.from_numpy(rgb), g, "plain")
    return jp, tp, comp, g


def _flat(tp, rgbval, g):
    flat = np.broadcast_to(np.asarray(rgbval, np.float32)[:, None, None],
                           (3, IDENT_L, N)).copy()[None]
    return encode_block(tp, torch.from_numpy(flat), g, "plain")


def _blind_decisions(jp, tp, comp, g):
    """The port's identify_parity at offsets 0, 1, 3, 2, and JAX's on the
    same composite."""
    got = [int(secam.identify_parity(tp, comp, g + o)[0]) for o in (0, 1, 3, 2)]
    ref = [int(jax_secam.identify_parity(jp, jnp.asarray(comp.numpy()),
                                         jnp.asarray((g + o).numpy()))[0])
           for o in (0, 1, 3, 2)]
    return got, ref


def test_ident_blind_correct_and_swapped(ident_setup):
    jp, tp, comp, g = ident_setup
    got, ref = _blind_decisions(jp, tp, comp, g)
    assert got == ref == [0, 1, 1, 0]


def test_ident_decode_identified_is_exact(ident_setup):
    _, tp, comp, g = ident_setup
    ref = secam.decode(tp, comp, g)
    got, swap = secam.decode_identified(tp, comp, g + 1)
    assert int(swap[0]) == 1
    assert torch.equal(got, ref)
    # and the failure it prevents is real
    assert float((secam.decode(tp, comp, g + 1) - ref).abs().max()) > 0.5


def test_ident_noise_and_per_batch_decisions(ident_setup):
    jp, tp, comp, g = ident_setup
    noise = np.random.default_rng(7).normal(0.0, 0.05, comp.shape).astype(np.float32)
    noisy = comp + torch.from_numpy(noise)
    assert [int(secam.identify_parity(tp, noisy, g + o)[0]) for o in (0, 1)] == [0, 1]
    swap = secam.identify_parity(tp, torch.cat([comp, comp]), torch.cat([g, g + 1]))
    assert swap.tolist() == [0, 1]


@pytest.mark.parametrize("pattern", ["bars", (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                     (0.0, 0.3, 0.8)], ids=str)
def test_ident_blind_on_bars_and_flats(ident_setup, pattern):
    jp, tp, _, g = ident_setup
    if pattern == "bars":
        bars = color_bars(IDENT_L, N).astype(np.float32)[None]
        comp = encode_block(tp, torch.from_numpy(bars), g, "plain")
    else:
        comp = _flat(tp, pattern, g)
    got, ref = _blind_decisions(jp, tp, comp, g)
    assert got == ref == [0, 1, 1, 0]


@pytest.mark.parametrize("rgbval", [(1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)])
def test_ident_lines_resolve_saturated_primaries(ident_setup, rgbval):
    jp, tp, _, g = ident_setup
    n_id = 4
    comp = _flat(tp, rgbval, g)
    rows = secam.ident_lines(tp, g[:, :n_id])
    ref_rows = np.asarray(jax_secam.ident_lines(jp, jnp.asarray(g[:, :n_id].numpy())))
    np.testing.assert_allclose(rows.numpy(), ref_rows, atol=ENC_ATOL)
    comp[:, :n_id] = rows
    for off, want in ((0, 0), (1, 1), (3, 1), (2, 0)):
        got = int(secam.identify_from_ident(tp, comp[:, :n_id], (g + off)[:, :n_id])[0])
        assert got == want, (off, got)


def test_ident_lines_under_noise(ident_setup):
    _, tp, comp, g = ident_setup
    n_id = 4
    comp = comp.clone()
    comp[:, :n_id] = secam.ident_lines(tp, g[:, :n_id])
    noise = np.random.default_rng(11).normal(0.0, 0.08, comp.shape).astype(np.float32)
    noisy = comp + torch.from_numpy(noise)
    got, swap = secam.decode_identified(tp, noisy, g + 1, ident_rows=n_id)
    assert int(swap[0]) == 1
    ref = secam.decode(tp, noisy, g)
    assert torch.equal(got[..., n_id:, :], ref[..., n_id:, :])



def test_ident_ramp_uploads_once():
    """The ident bottles' sawtooth is np.linspace's, uploaded once per
    width and device."""
    tp = plan_from_numpy(get_plan("secam"))
    g = torch.arange(4, dtype=torch.int32)
    first = secam.ident_lines(tp, g)
    hits = secam._ident_ramp.cache_info().hits
    torch.testing.assert_close(secam.ident_lines(tp, g), first, rtol=0, atol=0)
    assert secam._ident_ramp.cache_info().hits == hits + 1
    np.testing.assert_array_equal(
        secam._ident_ramp(tp.n_samples, torch.device("cpu")).numpy(),
        np.linspace(0.0, 1.0, tp.n_samples, dtype=np.float32))
