"""The PyTorch port's frame pipeline (the main-path slice) against the JAX
package and the golden oracle, on the CPU.

NTSC comb3 is the driver's main path; the other cases cover the decoders
the slice ports.  Bounds: composite 2e-5 and RGB 5e-4 against the JAX
``xla`` pipeline (the JAX package's kernel-vs-twin bounds), >= 60 dB
against the golden oracle (tests/test_roundtrip.py), round-trip PSNR equal
to JAX's to 0.01 dB.
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import TEST_LINES, TEST_SAMPLES, get_plan
from color_modem_tpu import golden
from color_modem_tpu.frame.pipeline import make_pipeline as jax_make_pipeline
from color_modem_tpu.utils.metrics import psnr as np_psnr
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.frame.pipeline import decode_block, make_pipeline
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils.metrics import psnr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME0 = 3
ENC_ATOL, DEC_ATOL = 2e-5, 5e-4
CASES = [("ntsc", "comb3"), ("ntsc", "notch"), ("ntsc", "comb2"), ("pal", "comb3")]


@pytest.fixture(scope="module")
def rgb():
    """Two different band-limited frames, (2, 3, L, N) float32."""
    return np.stack([
        smooth_scene(TEST_LINES, TEST_SAMPLES, seed=s) for s in (1, 2)
    ]).astype(np.float32)


_JAX_OUT = {}


def jax_outputs(name, decoder, rgb):
    """(composite, round-trip RGB) of the JAX xla pipeline at FRAME0."""
    if (name, decoder) not in _JAX_OUT:
        enc, _, rt = jax_make_pipeline(get_plan(name), decoder, "xla")
        x = jnp.asarray(rgb)
        _JAX_OUT[name, decoder] = (np.asarray(enc(x, FRAME0)), np.asarray(rt(x, FRAME0)))
    return _JAX_OUT[name, decoder]


def port_pipeline(name, decoder, backend):
    return make_pipeline(plan_from_numpy(get_plan(name)), decoder, backend, device="cpu")


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("name,decoder", CASES)
def test_slice_matches_jax_xla(name, decoder, backend, rgb):
    comp_j, out_j = jax_outputs(name, decoder, rgb)
    enc, dec, rt = port_pipeline(name, decoder, backend)
    comp = enc(rgb, FRAME0)
    np.testing.assert_allclose(comp.numpy(), comp_j, atol=ENC_ATOL)
    out = rt(rgb, FRAME0)
    np.testing.assert_allclose(out.numpy(), out_j, atol=DEC_ATOL)
    assert torch.equal(dec(comp, FRAME0), out)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_main_path_golden_parity_and_psnr(backend, rgb):
    jp = get_plan("ntsc")
    enc, _, rt = port_pipeline("ntsc", "comb3", backend)
    comp, out = enc(rgb, FRAME0).numpy(), rt(rgb, FRAME0).numpy()
    for b in range(rgb.shape[0]):
        comp_g = golden.encode_frame(jp, rgb[b], frame=FRAME0 + b)
        rgb_g = golden.decode_frame(jp, comp_g, frame=FRAME0 + b, decoder="comb3")
        assert np_psnr(comp[b], comp_g) >= 60.0, "encode parity vs golden"
        assert np_psnr(out[b], rgb_g) >= 60.0, "decode parity vs golden"
    _, out_j = jax_outputs("ntsc", "comb3", rgb)
    q = psnr(torch.from_numpy(out), torch.from_numpy(rgb))
    assert abs(q - np_psnr(out_j, rgb)) <= 0.01
    assert abs(q - np_psnr(out, rgb)) <= 1e-9


def _error_cases():
    """name -> (call on the JAX package, call on the port, message): the
    errors of the QAM-family paths."""
    from color_modem_tpu.frame import raster as jr
    from color_modem_tpu.frame.pipeline import decode_block as jax_decode_block
    from color_modem_tpu.separate.comb import stencil_signal as jax_stencil_signal
    from color_modem_tpu_torch.frame import raster
    from color_modem_tpu_torch.separate.comb import stencil_signal

    def plans(name):
        return get_plan(name), plan_from_numpy(get_plan(name))

    def both(fn_j, fn_t, name, x):
        jp, tp = plans(name)
        return (lambda: fn_j(jp, jnp.asarray(x)), lambda: fn_t(tp, torch.from_numpy(x)))

    comp3 = np.zeros((1, 4, TEST_SAMPLES), np.float32)   # one NTSC frame
    comp_pal = np.zeros((3, 4, TEST_SAMPLES), np.float32)  # PAL needs 4 frames
    g = np.zeros((1, 4), np.int32)
    cases = {
        "comb3d-ntsc-one-frame": (*both(
            lambda p, x: jax_stencil_signal(p, x, "comb3d"),
            lambda p, x: stencil_signal(p, x, "comb3d"), "ntsc", comp3), ">= 2 frames"),
        "comb3d-pal-three-frames": (*both(
            lambda p, x: jax_stencil_signal(p, x, "comb3d"),
            lambda p, x: stencil_signal(p, x, "comb3d"), "pal", comp_pal), ">= 4 frames"),
        "comb3d-unbatched": (*both(
            lambda p, x: jax_stencil_signal(p, x, "comb3d"),
            lambda p, x: stencil_signal(p, x, "comb3d"), "ntsc", comp3[0]),
            "batched"),
        "comb3d-ntsc443-no-spacing": (*both(
            lambda p, x: jax_stencil_signal(p, x, "comb3d"),
            lambda p, x: stencil_signal(p, x, "comb3d"), "ntsc443", comp3),
            "no temporal comb spacing"),
        "identify-vswitch-ntsc": (*both(
            lambda p, x: jr.identify_vswitch(p, jr.make_raster(p), x, jnp.asarray(g)),
            lambda p, x: raster.identify_vswitch(p, raster.make_raster(p), x,
                                                 torch.from_numpy(g)),
            "ntsc", np.zeros((1, 4, 858), np.float32)), "no swinging burst"),
        "burst-phase-secam": (*both(
            lambda p, x: jr.measure_burst_phase(p, jr.make_raster(p), x, jnp.asarray(g)),
            lambda p, x: raster.measure_burst_phase(p, raster.make_raster(p), x,
                                                    torch.from_numpy(g)),
            "secam", np.zeros((1, 4, 864), np.float32)), "no color burst"),
        "hooks-on-secam": (*both(
            lambda p, x: jax_decode_block(p, x, jnp.asarray(g), "notch",
                                          phase_err=jnp.zeros((1, 4))),
            lambda p, x: decode_block(p, x, torch.from_numpy(g), "notch",
                                      chroma_gain=torch.ones((1, 4))),
            "secam", comp3), "QAM standards only"),
    }
    return cases


ERROR_CASES = ["comb3d-ntsc-one-frame", "comb3d-pal-three-frames", "comb3d-unbatched",
               "comb3d-ntsc443-no-spacing", "identify-vswitch-ntsc", "burst-phase-secam",
               "hooks-on-secam"]


@pytest.mark.parametrize("case", ERROR_CASES)
def test_raises_where_jax_raises(case):
    """The QAM-family paths refuse what the JAX package refuses, with a
    ValueError on both sides.  One deliberate difference: the JAX package
    ignores phase_err/chroma_gain on SECAM (its FM branch never reads
    them), where the port refuses them."""
    call_j, call_t, msg = _error_cases()[case]
    if case == "hooks-on-secam":
        assert np.isfinite(np.asarray(call_j())).all()
    else:
        with pytest.raises(ValueError):
            call_j()
    with pytest.raises(ValueError, match=msg):
        call_t()


def test_bad_arguments_raise():
    plan = plan_from_numpy(get_plan("ntsc"))
    with pytest.raises(ValueError, match="supports decoders"):
        make_pipeline(plan, "interp", "kernel", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        make_pipeline(plan, "comb3", "xla", device="cpu")


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from color_modem_tpu_torch import NIIR, NTSC, PAL, SECAM
        from color_modem_tpu_torch.frame import channel, raster
        from color_modem_tpu_torch.frame.pipeline import make_pipeline
        from color_modem_tpu_torch.kernels import build, fir, qam, secam as secam_k
        from color_modem_tpu_torch.modem import niir, secam
        from color_modem_tpu_torch.modem.plan import make_plan
        from color_modem_tpu_torch.separate import delayline
        from color_modem_tpu_torch.utils.metrics import psnr
        from color_modem_tpu_torch.utils.testimages import smooth_scene
        import torch
        rgb = torch.tensor(smooth_scene(16, 720, seed=0)[None], dtype=torch.float32)
        _, _, rt = make_pipeline(make_plan(NTSC(), 720), "comb3", "kernel", device="cpu")
        assert psnr(rt(rgb, 0), rgb) > 30.0
        _, _, rt = make_pipeline(make_plan(SECAM(), 720), "avg", "kernel", device="cpu")
        assert psnr(rt(rgb, 1), rgb) > 25.0
        _, _, rt = make_pipeline(make_plan(PAL(), 720), "delayline", "kernel", device="cpu")
        assert psnr(rt(rgb, 2), rgb) > 30.0
        plan = make_plan(NIIR(), 720)
        enc, dec, rt = make_pipeline(plan, "avg", "kernel", device="cpu", raster=True)
        assert psnr(rt(rgb, 0), rgb) > 25.0
        bad = channel.impair(plan, enc(rgb, 0), chroma_gain=0.7)
        assert psnr(dec(bad, 0), rgb) > 25.0
        import tempfile
        from color_modem_tpu_torch.dsp import resample
        from color_modem_tpu_torch.frame import (
            deinterlace, interlace, nr, svideo, telecine, transcode, video)
        from color_modem_tpu_torch.utils import manifest
        _, _, rt = interlace.make_interlaced_pipeline(make_plan(NTSC(), 720), "comb3",
                                                      device="cpu")
        assert psnr(rt(rgb, 0), rgb) > 28.0
        with tempfile.TemporaryDirectory() as d:
            s = video.process_video(make_plan(PAL(), 720), video.synthetic_source(16, 720),
                                    3, d, decoder="delayline", chunk=2, device="cpu")
        assert s["frames_processed_this_run"] == 3 and s["min_psnr_db"] > 25.0
        from color_modem_tpu_torch.dsp import stream
        from color_modem_tpu_torch.frame import equalize, rf, satellite, timebase
        from color_modem_tpu_torch.modem import mac, mac_plan
        comp = make_pipeline(make_plan(NTSC(), 720), "notch", device="cpu")[0](rgb, 0)
        assert psnr(rf.rf_roundtrip(rf.make_rf_plan(make_plan(NTSC(), 720)), comp)[:, 2:-2],
                    comp[:, 2:-2]) > 55.0
        sp = satellite.make_sat_plan(13.5e6, 720)
        assert psnr(satellite.sat_roundtrip(sp, comp), comp) > 40.0
        mp = mac_plan.make_mac_plan(720)
        assert psnr(mac.roundtrip(mp, rgb, torch.arange(16)), rgb) > 35.0
        with tempfile.TemporaryDirectory() as d:
            s = video.process_video(make_plan(NTSC(), 720), video.synthetic_source(16, 720),
                                    2, d, decoder="comb3", chunk=2, device="cpu", rf=True,
                                    channel={"ghost_delay_us": 2.0, "ghost_gain": 0.2,
                                             "equalize": True})
        assert s["min_psnr_db"] > 30.0
        # the sound layer: every module runs
        from color_modem_tpu_torch.frame import a2, mts, nicam
        from color_modem_tpu_torch.utils import wav
        p = make_plan(NTSC(), 720)
        rfp = rf.make_rf_plan(p)
        t = np.arange(16 * 720) / p.fs
        tone = torch.tensor(0.5 * np.sin(2 * np.pi * 1000 * t), dtype=torch.float32)[None]
        snd = rf.sound_from_rf(rfp, rf.sound_on_rf(rfp, rf.rf_modulate(rfp, comp, 0), 0, tone), 0)
        assert psnr(snd[:, 4000:-4000], tone[:, 4000:-4000]) > 40.0
        l2, r2, pilot = mts.mts_decode(p, mts.mts_encode(p, tone, tone))
        assert abs(float(pilot[0]) - mts.PILOT_AMP) < 0.02
        left = torch.tensor(0.5 * np.sin(np.arange(64) * 0.3), dtype=torch.float32)
        assert int(nicam.parse_frames(nicam.nicam_frames(left, left))[2]["parity_errors"].sum()) == 0
        a2p = a2.make_a2_plan(rfp)
        assert a2.a2_decode(a2p, rf.rf_modulate(rfp, comp, 0, tone), 0)[2]["mode"] == ["mono"]
        sps = satellite.make_sat_plan(13.5e6, 720, audio_subs=1)
        aud = satellite.fm_demodulate_audio(sps, satellite.fm_modulate(
            sps, comp, audio=torch.zeros(1, 1, 16 * 720)))
        assert aud.shape == (1, 1, 16 * 720)
        payload, n_f = mac.pack_sound(mp, left, left, 16)
        assert mac.unpack_sound(mp, payload, n_f)[0].shape == left.shape
        assert wav.resample_linear(np.zeros(10, np.float32), 1.0, 2.0).shape == (20,)
        with tempfile.TemporaryDirectory() as d:
            s = video.process_video(p, video.synthetic_source(16, 720), 2, d, chunk=2,
                                    device="cpu", rf=True,
                                    rf_audio=np.zeros(2 * 16 * 720, np.float32))
        assert s["rf_audio"] is True
        import importlib, pkgutil
        import color_modem_tpu_torch as port
        for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(m.name)
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        ref = sorted(m for m in sys.modules if m.split(".")[0] == "color_modem_tpu")
        assert not ref, ref
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the system only through the port: no import of
    jax or of the JAX package, at any depth of the script."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    tops = {m.split(".")[0] for m in names}
    assert "color_modem_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "color_modem_tpu"}, sorted(tops)


def _factories():
    from color_modem_tpu_torch.frame import interlace, svideo, transcode, video
    from color_modem_tpu_torch.frame import pipeline as pl

    return {
        "make_pipeline": pl.make_pipeline,
        "make_interlaced_pipeline": interlace.make_interlaced_pipeline,
        "make_svideo_pipeline": svideo.make_svideo_pipeline,
        "make_transcoder": transcode.make_transcoder,
        "make_interlaced_transcoder": transcode.make_interlaced_transcoder,
        "synthetic_device_source": video.synthetic_device_source,
        "process_video": video.process_video,
    }


@pytest.mark.parametrize("name", sorted(_factories()))
def test_factories_default_to_the_card(name):
    """Every entry point runs on the card unless the caller asks for the
    CPU, as the CPU tests do."""
    import inspect

    assert inspect.signature(_factories()[name]).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", ["make_pipeline", "make_interlaced_pipeline",
                                  "make_svideo_pipeline", "make_transcoder",
                                  "synthetic_device_source", "process_video"])
def test_default_device_raises_without_cuda(name, monkeypatch, tmp_path):
    """With the default device and no CUDA, a factory raises before it does
    any work."""
    from color_modem_tpu_torch import NTSC, PAL
    from color_modem_tpu_torch.modem.plan import make_plan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ntsc = make_plan(NTSC(), 720)
    calls = {
        "make_pipeline": lambda f: f(ntsc, "comb3"),
        "make_interlaced_pipeline": lambda f: f(ntsc, "comb3"),
        "make_svideo_pipeline": lambda f: f(ntsc),
        "make_transcoder": lambda f: f(ntsc, make_plan(PAL(), 720)),
        "synthetic_device_source": lambda f: f(8, 720),
        "process_video": lambda f: f(ntsc, lambda s, c: np.zeros((c, 3, 8, 720), np.float32),
                                     2, str(tmp_path)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[name](_factories()[name])
