"""The PyTorch port's frame layer above the block against the JAX package,
on the CPU: resampling, interlaced fields, S-Video, standards conversion,
temporal noise reduction, deinterlacing and telecine.

The same NumPy-seeded inputs go through the JAX function (``xla`` backend)
and the port's, on both port backends where the module runs a kernel
(``kernel``: the wrappers' plain versions on CPU tensors; ``plain``).
Bounds: composite 2e-5 (SECAM 2e-4) and RGB 5e-4, as in
tests/test_torch_qam_family.py and tests/test_torch_secam.py; 1e-5 for
resampling, NR, deinterlacing and telecine on the same RGB;
``resample_matrix`` bit-equal.  The behaviour tests of tests/test_nr.py,
test_deinterlace.py and test_telecine.py run on the port as well.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import TEST_LINES, TEST_SAMPLES, get_plan
from color_modem_tpu.dsp import design as jdesign
from color_modem_tpu.dsp.resample import resample_width as jax_resample_width
from color_modem_tpu.frame import deinterlace as jdi
from color_modem_tpu.frame import interlace as jil
from color_modem_tpu.frame import nr as jnr
from color_modem_tpu.frame import telecine as jtc
from color_modem_tpu.frame import transcode as jtr
from color_modem_tpu.frame.pipeline import make_pipeline as jax_make_pipeline
from color_modem_tpu.frame.svideo import make_svideo_pipeline as jax_make_svideo
from color_modem_tpu.standards.decoders import allowed_decoders
from color_modem_tpu.utils.metrics import psnr
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.resample import resample_width
from color_modem_tpu_torch.frame import deinterlace as di
from color_modem_tpu_torch.frame import interlace as il
from color_modem_tpu_torch.frame import nr
from color_modem_tpu_torch.frame import telecine as tc
from color_modem_tpu_torch.frame import transcode as tr
from color_modem_tpu_torch.frame.channel import impair
from color_modem_tpu_torch.frame.pipeline import decode_block, make_pipeline
from color_modem_tpu_torch.frame.svideo import make_svideo_pipeline
from color_modem_tpu_torch.kernels import launch_counts, reset_launches
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401

ENC_ATOL, SECAM_ENC_ATOL, DEC_ATOL = 2e-5, 2e-4, 5e-4
RGB_ATOL = 1e-5  # resample, NR, deinterlace, telecine on the same RGB
BACKENDS = ["kernel", "plain"]
L, N = TEST_LINES, TEST_SAMPLES


def tplan(name):
    return plan_from_numpy(get_plan(name))


def enc_atol(name):
    return SECAM_ENC_ATOL if get_plan(name).cfg.is_fm else ENC_ATOL


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    reset_launches()
    yield
    assert set(launch_counts().values()) == {0}


@pytest.fixture(scope="module")
def img():
    return smooth_scene(L, N, seed=5).astype(np.float32)[None]


_JAX = {}


def cached(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


# --- resampling ---------------------------------------------------------------


@pytest.mark.parametrize("n_in,n_out", [(480, 576), (576, 480), (720, 1440), (40, 48)])
def test_resample_matrix_bit_equal(n_in, n_out):
    np.testing.assert_array_equal(design.resample_matrix(n_in, n_out),
                                  jdesign.resample_matrix(n_in, n_out))


@pytest.mark.parametrize("n_out", [1440, 600])
def test_resample_width_matches_jax(n_out, img):
    x = img[0, :, :8]
    got = resample_width(torch.from_numpy(x), n_out)
    assert got.shape == (3, 8, n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_resample_width(jnp.asarray(x), n_out)),
                               atol=RGB_ATOL)


def test_resample_width_same_width_is_identity(img):
    x = torch.from_numpy(img)
    assert resample_width(x, N) is x


def test_resample_lines_shape_and_dc():
    y = tr.resample_lines(torch.ones((2, 3, 40, N)), 48)
    assert y.shape == (2, 3, 48, N)
    np.testing.assert_allclose(y.numpy(), 1.0, atol=1e-5)
    x = smooth_scene(40, N, seed=17).astype(np.float32)[None]
    np.testing.assert_allclose(tr.resample_lines(torch.from_numpy(x), 48).numpy(),
                               np.asarray(jtr.resample_lines(jnp.asarray(x), 48)),
                               atol=RGB_ATOL)


# --- interlace ----------------------------------------------------------------


def test_split_weave_roundtrip(img):
    rgb = np.concatenate([img, img[:, ::-1]], axis=0).copy()
    fields = il.split_fields(torch.from_numpy(rgb))
    assert fields.shape == (4, 3, L // 2, N)
    np.testing.assert_array_equal(fields.numpy(), np.asarray(jil.split_fields(jnp.asarray(rgb))))
    np.testing.assert_array_equal(il.weave_fields(fields).numpy(), rgb)
    np.testing.assert_array_equal(fields[1].numpy(), rgb[0, :, 1::2])


def test_split_and_weave_refuse_odd_sizes():
    with pytest.raises(ValueError, match="even line count"):
        il.split_fields(torch.zeros((1, 3, 5, N)))
    with pytest.raises(ValueError, match="must be even"):
        il.weave_fields(torch.zeros((3, 3, 4, N)))


def test_field_line_index_values():
    plan = tplan("ntsc")
    assert il.field_offset(plan) == 263
    assert il.field_offset(tplan("pal")) == 313
    g = il.field_line_index(plan, 2, 2, 4, "cpu")
    assert g.dtype == torch.int32 and g.shape == (4, 4)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jil.field_line_index(get_plan("ntsc"),
                                                                             2, 2, 4)))
    np.testing.assert_array_equal(g[1].numpy(), 2 * 525 + 263 + np.arange(4))


def _jax_interlaced(name, decoder, rgb):
    def run():
        enc, _, rt = jil.make_interlaced_pipeline(get_plan(name), decoder)
        x = jnp.asarray(rgb)
        return np.asarray(enc(x, 0)), np.asarray(rt(x, 0))
    return cached(("interlaced", name, decoder, rgb.shape), run)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,decoder", [("ntsc", "comb3"), ("pal", "delayline"),
                                          ("secam", "notch")])
def test_interlaced_roundtrip_matches_jax(name, decoder, backend, img):
    comp_j, out_j = _jax_interlaced(name, decoder, img)
    enc, dec, rt = il.make_interlaced_pipeline(tplan(name), decoder, backend, device="cpu")
    comp = enc(img, 0)
    assert comp.shape == (2, L // 2, N)
    np.testing.assert_allclose(comp.numpy(), comp_j, atol=enc_atol(name))
    out = rt(img, 0)
    np.testing.assert_allclose(out.numpy(), out_j, atol=DEC_ATOL)
    assert torch.equal(dec(comp, 0), out)
    assert psnr(out.numpy(), img) > 28.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_interlaced_comb3d_parity_major_matches_jax(backend, img):
    """Parity-major comb3d on 4 static frames: the regrouped planes and the
    regrouped line map reach the decode wrapper in the same order (a
    mismatch would demodulate with the wrong phase), and the temporal comb
    beats the spatial one by more than 3 dB."""
    rgb = np.ascontiguousarray(np.broadcast_to(img[0], (4,) + img.shape[1:]))
    _, out_j = _jax_interlaced("ntsc", "comb3d", rgb)
    _, _, rt_t = il.make_interlaced_pipeline(tplan("ntsc"), "comb3d", backend, device="cpu")
    _, _, rt_s = il.make_interlaced_pipeline(tplan("ntsc"), "comb3", backend, device="cpu")
    out = rt_t(rgb, 0)
    np.testing.assert_allclose(out.numpy(), out_j, atol=DEC_ATOL)
    p_t, p_s = psnr(out.numpy(), rgb), psnr(rt_s(rgb, 0).numpy(), rgb)
    assert p_t > p_s + 3.0 and p_t > 40.0, (p_s, p_t)


def test_interlaced_raster_strip_is_exact(img):
    from color_modem_tpu_torch.frame import raster

    plan = tplan("ntsc")
    enc_r, dec_r, _ = il.make_interlaced_pipeline(plan, "comb3", raster=True, device="cpu")
    enc, _, rt = il.make_interlaced_pipeline(plan, "comb3", device="cpu")
    comp_r, comp = enc_r(img, 0), enc(img, 0)
    assert comp_r.shape[-1] > N
    assert torch.equal(raster.strip_raster(raster.make_raster(plan), comp_r), comp)
    assert torch.equal(dec_r(comp_r, 0), rt(img, 0))


def test_field_blocks_decoded_apart_equal_together(img):
    plan = tplan("ntsc")
    enc, dec, _ = il.make_interlaced_pipeline(plan, "comb3", device="cpu")
    comp = enc(img, 0)
    g = il.field_line_index(plan, 0, 1, L // 2, "cpu")
    parts = [decode_block(plan, comp[k : k + 1], g[k : k + 1], "comb3") for k in range(2)]
    np.testing.assert_allclose(dec(comp, 0).numpy(),
                               il.weave_fields(torch.cat(parts)).numpy(), atol=1e-6)


# --- S-Video ------------------------------------------------------------------

SV_LINES = 48


@pytest.fixture(scope="module")
def sv_img():
    return smooth_scene(SV_LINES, N, seed=21).astype(np.float32)[None]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["ntsc", "pal", "secam", "niir"])
def test_svideo_matches_jax_and_y_plus_c_is_the_composite(name, backend, sv_img):
    def run():
        enc, _, rt = jax_make_svideo(get_plan(name))
        x = jnp.asarray(sv_img)
        return np.asarray(enc(x, 2)), np.asarray(rt(x, 2))

    yc_j, out_j = cached(("svideo", name), run)
    enc, dec, rt = make_svideo_pipeline(tplan(name), backend, device="cpu")
    yc = enc(sv_img, 2)
    np.testing.assert_allclose(yc.numpy(), yc_j, atol=enc_atol(name))
    comp, _, _ = make_pipeline(tplan(name), allowed_decoders(get_plan(name).cfg)[0], backend,
                               device="cpu")
    np.testing.assert_allclose((yc[:, 0] + yc[:, 1]).numpy(), comp(sv_img, 2).numpy(), atol=1e-7)
    out = rt(sv_img, 2)
    np.testing.assert_allclose(out.numpy(), out_j, atol=DEC_ATOL)
    assert torch.equal(dec(yc, 2), out)


def test_svideo_luma_plane_is_unfiltered_matrix_luma(sv_img):
    enc, _, _ = make_svideo_pipeline(tplan("ntsc"), device="cpu")
    y = enc(sv_img, 0)[0, 0].numpy()
    expect = 0.299 * sv_img[0, 0] + 0.587 * sv_img[0, 1] + 0.114 * sv_img[0, 2]
    np.testing.assert_allclose(y, expect, atol=2e-6)


@pytest.mark.parametrize("name", ["ntsc", "pal", "secam", "niir"])
def test_svideo_beats_every_composite_decoder(name, sv_img):
    """tests/test_svideo.py's margins: over 2 dB on QAM, never a loss on
    SECAM (its FM demodulator is the same on both wires)."""
    _, _, rt_s = make_svideo_pipeline(tplan(name), device="cpu")
    p_s = psnr(rt_s(sv_img, 0).numpy(), sv_img)
    margin = 0.0 if get_plan(name).cfg.is_fm else 2.0
    for decoder in allowed_decoders(get_plan(name).cfg):
        if decoder in ("comb3d", "comb3dA"):
            continue
        _, _, rt_c = make_pipeline(tplan(name), decoder, device="cpu")
        assert p_s > psnr(rt_c(sv_img, 0).numpy(), sv_img) + margin, (name, decoder)


# --- standards conversion -------------------------------------------------------


def _src_lines(name):
    return 40 if get_plan(name).cfg.active_lines == 480 else 48


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("src,dst", [("ntsc", "pal"), ("pal", "ntsc"), ("ntsc", "secam"),
                                     ("secam", "pal")])
def test_conversion_matches_jax(src, dst, backend):
    l_src = _src_lines(src)
    img = smooth_scene(l_src, N, seed=17).astype(np.float32)[None]

    def run():
        comp_s = np.asarray(jax_make_pipeline(get_plan(src), "notch")[0](jnp.asarray(img), 0))
        return comp_s, np.asarray(jtr.make_transcoder(get_plan(src), get_plan(dst))(
            jnp.asarray(comp_s), 0))

    comp_s, comp_j = cached(("transcode", src, dst), run)
    comp_d = tr.make_transcoder(tplan(src), tplan(dst), backend=backend, device="cpu")(comp_s, 0)
    l_dst = round(l_src * get_plan(dst).cfg.active_lines / get_plan(src).cfg.active_lines)
    assert comp_d.shape == (1, l_dst, N)
    np.testing.assert_allclose(comp_d.numpy(), comp_j, atol=DEC_ATOL)
    _, dec_d, _ = make_pipeline(tplan(dst), tr.best_decoder(tplan(dst)), backend, device="cpu")
    ref = tr.resample_lines(torch.from_numpy(img), l_dst)
    assert psnr(dec_d(comp_d, 0).numpy(), ref.numpy()) > 26.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_interlaced_conversion_matches_jax(backend):
    img = smooth_scene(40, N, seed=19).astype(np.float32)[None]

    def run():
        fields = jil.make_interlaced_pipeline(get_plan("ntsc"), "comb3")[0](jnp.asarray(img), 0)
        conv = jtr.make_interlaced_transcoder(get_plan("ntsc"), get_plan("pal"))
        return np.asarray(fields), np.asarray(conv(fields, 0))

    fields_s, fields_j = cached(("transcode-interlaced",), run)
    conv = tr.make_interlaced_transcoder(tplan("ntsc"), tplan("pal"), backend=backend,
                                         device="cpu")
    fields_d = conv(fields_s, 0)
    assert fields_d.shape == (2, 24, N)
    np.testing.assert_allclose(fields_d.numpy(), fields_j, atol=DEC_ATOL)
    _, dec_d, _ = il.make_interlaced_pipeline(tplan("pal"), "comb3", backend, device="cpu")
    ref = tr.resample_lines(torch.from_numpy(img), 48)
    assert psnr(dec_d(fields_d, 0).numpy(), ref.numpy()) > 26.0


def test_best_decoder_choices():
    for name, want in (("ntsc", "comb3"), ("pal", "comb3"), ("secam", "notch"),
                       ("niir", "notch")):
        assert tr.best_decoder(tplan(name)) == want == jtr.best_decoder(get_plan(name))


# --- temporal noise reduction ---------------------------------------------------

NR_LINES, SIGMA = 48, 0.03


def _noisy(clean, seed, sigma=SIGMA):
    rng = np.random.default_rng(seed)
    return (clean + sigma * rng.standard_normal(clean.shape)).astype(np.float32)


def _scene(seed, lines=NR_LINES):
    return smooth_scene(lines, N, seed=seed).astype(np.float32)


@pytest.mark.parametrize("sigma", [SIGMA, None])
def test_temporal_nr_matches_jax(sigma):
    one = _scene(31)
    clean = np.stack([np.roll(one, 5 * t, axis=-1) * (1.0 + 0.02 * t) for t in range(5)])
    x = _noisy(clean, 0)
    got = nr.temporal_nr(torch.from_numpy(x), sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnr.temporal_nr(jnp.asarray(x), sigma)),
                               atol=RGB_ATOL)


@pytest.mark.parametrize("width,axis", [(9, -1), (9, -2), (3, 0)])
def test_box_smooth_matches_jax(width, axis):
    x = np.random.default_rng(width).random((4, 6, 40)).astype(np.float32)
    np.testing.assert_allclose(nr.box_smooth(torch.from_numpy(x), width, axis).numpy(),
                               np.asarray(jnr.box_smooth(jnp.asarray(x), width, axis)),
                               atol=RGB_ATOL)
    with pytest.raises(ValueError, match="odd"):
        nr.box_smooth(torch.from_numpy(x), 4, -1)


@pytest.mark.parametrize("n", [1, 2, 5, 1001, 4096])
def test_lower_quartile_is_jnp_percentile(n):
    d = np.random.default_rng(n).random(n).astype(np.float32)
    got = float(nr.lower_quartile(torch.from_numpy(d)))
    # the same position and weights; XLA may fuse the last multiply-add
    np.testing.assert_allclose(got, float(jnp.percentile(jnp.asarray(d), 25.0)), rtol=1e-6)
    assert abs(got - np.percentile(d.astype(np.float64), 25.0)) <= 1e-6


def test_static_noise_is_reduced():
    clean = np.broadcast_to(_scene(31), (6, 3, NR_LINES, N))
    noisy = _noisy(clean, 0)
    before = psnr(noisy, clean)
    after = psnr(nr.temporal_nr(torch.from_numpy(noisy), SIGMA).numpy(), clean)
    assert after - before > 3.0, (before, after)


def test_motion_does_not_ghost():
    one = _scene(32)
    clean = np.stack([np.roll(one, 23 * t, axis=-1) for t in range(6)])
    noisy = _noisy(clean, 1)
    after = psnr(nr.temporal_nr(torch.from_numpy(noisy), SIGMA).numpy(), clean)
    assert after > psnr(noisy, clean) - 0.3


def test_flicker_is_compensated_not_averaged_in():
    one = _scene(34)
    clean = np.stack([g * one for g in 1.0 + 0.04 * np.cos(0.9 * np.arange(6))])
    noisy = _noisy(clean, 3)
    after = psnr(nr.temporal_nr(torch.from_numpy(noisy)).numpy(), clean)
    assert after - psnr(noisy, clean) > 2.5


@pytest.mark.parametrize("name,decoder,gain", [("ntsc", "comb3", 3.0), ("secam", "notch", 1.0)])
def test_nr_end_to_end_noisy_channel(name, decoder, gain):
    plan = tplan(name)
    rgb = np.ascontiguousarray(np.broadcast_to(_scene(33), (6, 3, NR_LINES, N)))
    enc, dec, _ = make_pipeline(plan, decoder, device="cpu")
    comp = impair(plan, enc(rgb, 0), noise_sigma=0.02, key=prng.PRNGKey(2))
    out = dec(comp, 0)
    p_raw = psnr(out.numpy(), rgb)
    assert psnr(nr.temporal_nr(out).numpy(), rgb) - p_raw > gain


def test_nr_shape_validation():
    with pytest.raises(ValueError, match="batch"):
        nr.temporal_nr(torch.zeros((3, NR_LINES, N)), 0.02)


# --- deinterlace ----------------------------------------------------------------

DI_LINES = 48


def _scene_at(t, motion):
    return np.roll(_scene(44, DI_LINES), motion * t, axis=-1)


def _field_rate_frames(n_instants, motion):
    return np.stack([_scene_at(t, motion) for t in range(n_instants)])


@pytest.mark.parametrize("motion", [0, 9])
def test_deinterlace_functions_match_jax(motion):
    rgb2x = _field_rate_frames(6, motion)
    fields = di.fields_from_framerate(torch.from_numpy(rgb2x))
    fields_j = jdi.fields_from_framerate(jnp.asarray(rgb2x))
    np.testing.assert_array_equal(fields.numpy(), np.asarray(fields_j))
    np.testing.assert_array_equal(di.weave(fields).numpy(), np.asarray(jdi.weave(fields_j)))
    np.testing.assert_array_equal(di.bob(fields).numpy(), np.asarray(jdi.bob(fields_j)))
    noisy = _noisy(fields.numpy(), motion)
    np.testing.assert_allclose(di.deinterlace(torch.from_numpy(noisy), sigma=0.01).numpy(),
                               np.asarray(jdi.deinterlace(jnp.asarray(noisy), sigma=0.01)),
                               atol=RGB_ATOL)


def _score(frames, motion, parity_time=1):
    return float(np.mean([psnr(np_(frames[t]), _scene_at(t * parity_time, motion))
                          for t in range(frames.shape[0])]))


def test_fields_from_framerate_geometry():
    rgb2x = torch.from_numpy(_field_rate_frames(4, 5))
    fields = di.fields_from_framerate(rgb2x)
    assert fields.shape == (4, 3, DI_LINES // 2, N)
    assert torch.equal(fields[1], rgb2x[1, :, 1::2])
    static = rgb2x[:1].expand(4, -1, -1, -1)
    assert torch.equal(di.fields_from_framerate(static), il.split_fields(static[0::2]))


def test_static_weave_is_exact_and_motion_combs():
    static = di.fields_from_framerate(torch.from_numpy(_field_rate_frames(4, 0)))
    np.testing.assert_allclose(di.weave(static)[0].numpy(), _scene_at(0, 0), atol=1e-6)
    moving = di.fields_from_framerate(torch.from_numpy(_field_rate_frames(4, 9)))
    w = di.weave(moving)
    p_weave = max(_score(w, 9, parity_time=2),
                  float(np.mean([psnr(w[t].numpy(), _scene_at(2 * t + 1, 9))
                                 for t in range(w.shape[0])])))
    assert _score(di.bob(moving), 9) > p_weave + 3.0


def test_adaptive_tracks_the_better_regime():
    for motion in (0, 9):
        fields = di.fields_from_framerate(torch.from_numpy(_field_rate_frames(6, motion)))
        p_a = _score(di.deinterlace(fields, sigma=0.005), motion)
        p_b = _score(di.bob(fields), motion)
        assert p_a > p_b - 1.0, (motion, p_b, p_a)
        if motion == 0:
            assert p_a > p_b + 6.0, (p_b, p_a)


def test_deinterlace_end_to_end_through_the_modem():
    motion = 7
    fields_rgb = di.fields_from_framerate(torch.from_numpy(_field_rate_frames(8, motion)))
    enc, dec, _ = il.make_interlaced_pipeline(tplan("ntsc"), "combA", device="cpu")
    decoded = dec(enc(il.weave_fields(fields_rgb), 0), 0)
    adap = di.deinterlace(il.split_fields(decoded), sigma=0.01)
    p_weave = float(np.mean([psnr(decoded[t].numpy(), _scene_at(2 * t, motion))
                             for t in range(decoded.shape[0])]))
    p_adap = _score(adap, motion)
    assert p_adap > p_weave + 2.0 and p_adap > 27.0, (p_weave, p_adap)


def test_deinterlace_validation():
    with pytest.raises(ValueError, match="even"):
        di.fields_from_framerate(torch.zeros((3, 3, DI_LINES, N)))
    with pytest.raises(ValueError, match="even"):
        di.deinterlace(torch.zeros((3, 3, DI_LINES // 2, N)))


# --- telecine -------------------------------------------------------------------

TC_LINES = 32


def _film(frames=8, lines=TC_LINES):
    one = smooth_scene(lines, N, seed=2)
    return np.stack([np.roll(one, 13 * i, axis=-1) for i in range(frames)]).astype(np.float32)


def test_telecine_matches_jax_and_cadence_structure():
    film = _film(4)
    fields = tc.telecine(film)
    np.testing.assert_array_equal(fields.numpy(), np.asarray(jtc.telecine(film)))
    assert fields.shape == (10, 3, TC_LINES // 2, N)
    assert torch.equal(fields[4], fields[2]) and torch.equal(fields[9], fields[7])
    np.testing.assert_array_equal(fields[5].numpy(), film[2, :, 1::2])
    noisy = _noisy(np.asarray(jtc.telecine(_film(8))), 4)
    np.testing.assert_allclose(tc.cadence_metric(noisy).numpy(),
                               np.asarray(jtc.cadence_metric(noisy)), rtol=RGB_ATOL)


@pytest.mark.parametrize("phase", [0, 2, 4, 6, 8])
def test_inverse_telecine_exact_at_every_phase(phase):
    film = _film(12)
    fields = tc.telecine(film)[phase:]
    det, conf = tc.detect_pulldown_phase(fields)
    assert (det, phase) == (phase, jtc.detect_pulldown_phase(fields.numpy())[0])
    assert conf > 50.0
    out = tc.inverse_telecine(fields, det)
    skip = 0 if phase == 0 else 4
    np.testing.assert_array_equal(out.numpy(), film[skip : skip + out.shape[0]])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jtc.inverse_telecine(fields.numpy(),
                                                                               det)))


def test_inverse_telecine_detects_under_noise():
    film = _film(12)
    noisy = _noisy(tc.telecine(film).numpy(), 0, sigma=0.02)
    det, conf = tc.detect_pulldown_phase(noisy)
    assert det == 0 and conf > 3.0
    out = tc.inverse_telecine(noisy)
    assert psnr(out.numpy(), film[: out.shape[0]]) > 33.0


def test_plain_video_has_no_cadence():
    video = np.stack([np.roll(smooth_scene(TC_LINES // 2, N, seed=7), 17 * i, -1)
                      for i in range(30)]).astype(np.float32)
    assert tc.detect_pulldown_phase(video)[1] < 2.0


def test_telecine_validation():
    with pytest.raises(ValueError, match="multiple of 4"):
        tc.telecine(np.zeros((3, 3, 4, 8), np.float32))
    with pytest.raises(ValueError, match="even in 0..8"):
        tc.inverse_telecine(np.zeros((20, 3, 2, 8), np.float32), 3)
    with pytest.raises(ValueError, match=">= 12 fields"):
        tc.detect_pulldown_phase(np.zeros((10, 3, 2, 8), np.float32))


def test_film_through_interlaced_broadcast():
    plan = tplan("ntsc")
    film = _film(8)
    frames = il.weave_fields(tc.telecine(film))
    _, _, rt = il.make_interlaced_pipeline(plan, "comb3", device="cpu")
    rx_fields = il.split_fields(rt(frames, 0))
    det, conf = tc.detect_pulldown_phase(rx_fields)
    assert det == 0 and conf > 5.0
    out = tc.inverse_telecine(rx_fields, det)
    assert psnr(out.numpy(), film[: out.shape[0]]) > 33.0
