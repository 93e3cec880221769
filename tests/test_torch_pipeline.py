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
from torch_threads import one_torch_thread  # noqa: F401

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
        # the parallel layer: a one-rank mesh
        from color_modem_tpu_torch.parallel import halo, mesh, multihost, sharded
        m = mesh.make_mesh(backend="gloo", device="cpu")
        _, _, rt = sharded.make_sharded_pipeline(make_plan(NTSC(), 720), m, "comb3")
        assert psnr(mesh.gather_blocks(m, rt(mesh.local_block(m, rgb), 0)), rgb) > 30.0
        torch.distributed.destroy_process_group()
        # the surfaces: the native codec, Y4M, a line modem, the sanitizer, the CLI
        import contextlib, io, json
        from color_modem_tpu_torch import cli, native
        from color_modem_tpu_torch.compat import NtscModem
        from color_modem_tpu_torch.frame import image_io, y4m
        from color_modem_tpu_torch.utils import debug, testimages
        bars = testimages.color_bars(4, 720).astype(np.float32)
        assert np.array_equal(native.chw_f32_to_rgb8(native.rgb8_to_chw_f32(
            native.chw_f32_to_rgb8(bars[None]))), native.chw_f32_to_rgb8(bars[None]))
        with tempfile.TemporaryDirectory() as d:
            assert y4m.write_y4m(d + "/c.y4m", [bars]) == 1
            assert y4m.y4m_source(d + "/c.y4m")[1:] == (1, 4, 720)
            image_io.save_rgb(d + "/c.ppm", bars)
        modem = NtscModem(720, device="cpu")
        assert modem.modulate(0, 0, *bars[:, 0]).shape == (720,)
        assert debug.checked(lambda x: x + 1)(torch.zeros(2)).sum() == 2
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(["roundtrip", "--demo", "--lines", "16", "--device", "cpu"]) == 0
        assert json.loads(out.getvalue())["psnr_db"] > 20.0
        # the benchmark, the profiling helpers, the root factories, the entry point
        import os
        from color_modem_tpu_torch import benchmark, entry, make_transcoder
        from color_modem_tpu_torch.utils import profiling
        with tempfile.TemporaryDirectory() as d:
            here = os.getcwd()
            os.chdir(d)
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    benchmark.main(["--device", "cpu", "--batch", "1", "--lines", "16",
                                    "--iters", "1"])
                with open("results/bench_ntsc_comb3_kernel.json") as f:
                    assert json.load(f)["roundtrip_psnr_db"] > 30.0
            finally:
                os.chdir(here)
        assert profiling.measure(torch.add, rgb, 1.0, iters=1)["seconds_per_call"] > 0.0
        assert make_transcoder("ntsc", "pal", device="cpu")(comp, 0).shape == (1, 19, 720)
        step, (zeros,) = entry.entry(device="cpu")
        assert step(zeros[:, :, :16]).shape == (2, 3, 16, 720)
        # the correctness layer: the oracle (one call of each family), the
        # per-operation float checks, the kernels' memory sanitizer
        from color_modem_tpu_torch import golden
        from color_modem_tpu_torch.golden import frame as g_frame, mac as g_mac
        from color_modem_tpu_torch.golden import modems as g_modems, palplus as g_pp
        from color_modem_tpu_torch.golden import sound as g_sound, transmission as g_tx
        from color_modem_tpu_torch.kernels import sanitize
        from color_modem_tpu_torch.frame import palplus as f_pp
        img = testimages.smooth_scene(16, 720, seed=0)
        gp = make_plan(NTSC(), 720)
        g_comp = golden.encode_frame(gp, img)
        assert psnr(torch.tensor(golden.decode_frame(gp, g_comp, decoder="comb3")),
                    torch.tensor(img)) > 30.0
        assert g_frame.decode_sequence(gp, np.stack([g_comp] * 2), decoder="comb3d").shape == (
            2, 3, 16, 720)
        assert g_modems.line_phase0_exact(455, 2, 3) == g_modems.TWO_PI * 0.5
        assert g_tx.rf_demodulate(rfp, g_tx.rf_modulate(rfp, g_comp[None])).shape == (1, 16, 720)
        assert g_sound.mts_decode(720, np.full(31, 1 / 31), g_sound.mts_encode(
            720, np.zeros((1, 1440)), np.zeros((1, 1440))))[0].shape == (1, 1440)
        assert g_mac.decode_frame(mp, g_mac.encode_frame(mp, img)).shape == (3, 16, 720)
        pal = make_plan(PAL(), 720)
        assert g_pp.decode_palplus(pal, g_pp.encode_palplus(pal, img, f_pp._helper_taps(pal)),
                                   f_pp._helper_taps(pal)).shape == (3, 16, 720)
        assert sanitize.guarded_call(lambda v: v[1].copy_(v[0]), [rgb, torch.empty_like(rgb)],
                                     [1], 64)["sentinels_intact"]
        try:
            debug.checked(lambda x: torch.where(x > 0, x.log(), 0.0))(torch.zeros(2) - 1)
            raise AssertionError("checked let a NaN made inside through")
        except FloatingPointError:
            pass
        # JAX's keys and samplers: the plain threefry on the CPU
        from color_modem_tpu_torch.kernels import prng as prng_k
        from color_modem_tpu_torch.utils import prng
        assert prng.split(prng.PRNGKey(7))[0] == (3625411723, 1954958720)
        assert prng_k.threefry_bits(prng.PRNGKey(0), (8,), "cpu").shape == (8,)
        noisy = channel.impair(plan, enc(rgb, 0), noise_sigma=0.02, key=prng.PRNGKey(0))
        assert psnr(dec(noisy, 0), rgb) > 20.0
        # every module of the port, found by walking the package
        import importlib, pkgutil
        import color_modem_tpu_torch as port
        walked = {m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")}
        for name in sorted(walked):
            importlib.import_module(name)
        surfaces = {"cli", "native", "compat", "compat.line_api", "frame.y4m",
                    "frame.image_io", "utils.debug", "utils.testimages", "benchmark",
                    "entry", "utils.profiling", "golden", "golden.frame", "golden.mac",
                    "golden.modems", "golden.palplus", "golden.sound", "golden.transmission",
                    "kernels.sanitize", "kernels.prng", "utils.prng"}
        assert {"color_modem_tpu_torch." + n for n in surfaces} <= walked, sorted(walked)
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        ref = sorted(m for m in sys.modules if m.split(".")[0] == "color_modem_tpu")
        assert not ref, ref
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


#: the one import of ``kernels/`` the lower layers make: the band-tile format,
#: host NumPy code that the plans build their tiles with
LOWER_LAYER_KERNEL_IMPORTS = {("modem/plan.py", "color_modem_tpu_torch.kernels.tiles")}


def _imported_modules(tree: ast.AST) -> set:
    """Every module an ``import`` or ``from ... import`` of ``tree`` names, at
    any depth (a function's lazy imports too); ``from package import module``
    names the module."""
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module:
            names.add(n.module)
            names |= {f"{n.module}.{a.name}" for a in n.names}
    return names


def test_lower_layers_never_import_the_kernels():
    """``dsp/``, ``separate/`` and ``modem/`` hold the plain versions and
    import nothing of ``kernels/``, which imports them: the kernel-or-plain
    choice is made above them (``frame/pipeline.py::STAGES``).  The one
    exception is ``modem/plan.py``'s import of ``kernels/tiles.py``."""
    port = os.path.join(REPO, "color_modem_tpu_torch")
    seen = set()
    for layer in ("dsp", "separate", "modem"):
        for name in sorted(os.listdir(os.path.join(port, layer))):
            if not name.endswith(".py"):
                continue
            rel = f"{layer}/{name}"
            with open(os.path.join(port, rel)) as f:
                mods = _imported_modules(ast.parse(f.read()))
            for m in mods:
                if m.split(".")[:2] == ["color_modem_tpu_torch", "kernels"]:
                    m = ".".join(m.split(".")[:3])   # the module under kernels/
                    assert (rel, m) in LOWER_LAYER_KERNEL_IMPORTS, f"{rel} imports {m}"
                    seen.add((rel, m))
    assert seen == LOWER_LAYER_KERNEL_IMPORTS


def test_one_launch_counter_keyed_by_the_library():
    """``launch_counts()`` has one key per C entry point of
    ``kernels/build.py::SIGNATURES`` (the check FIRs' too), and
    ``reset_launches()`` sets every one to 0."""
    from color_modem_tpu_torch.kernels import build, launch_counts, reset_launches

    assert set(launch_counts()) == set(build.SIGNATURES)
    saved = launch_counts()
    try:
        for k, name in enumerate(build.SIGNATURES):
            build.LAUNCHES[name] = k + 1
        assert launch_counts() == {name: k + 1 for k, name in enumerate(build.SIGNATURES)}
        reset_launches()
        assert launch_counts() == dict.fromkeys(build.SIGNATURES, 0)
    finally:
        build.LAUNCHES.update(saved)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the system only through the port: no import of
    jax or of the JAX package, at any depth of the script; and importing
    every module of the port that it names, in a fresh process, loads no
    jax either.  The script drives the surfaces too (phase 7)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module:
            names.append(n.module)
            # `from package import module` names modules too
            names += [f"{n.module}.{a.name}" for a in n.names]
    tops = {m.split(".")[0] for m in names}
    assert "color_modem_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "color_modem_tpu"}, sorted(tops)
    port = sorted({m for m in names if m.split(".")[0] == "color_modem_tpu_torch"})
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {port!r}:
            try:
                importlib.import_module(name)
            except ModuleNotFoundError:
                # `from module import function`: the module must import
                importlib.import_module(name.rsplit(".", 1)[0])
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        loaded = sorted(m for m in sys.modules if m.startswith("color_modem_tpu"))
        assert all(m.split(".")[0] == "color_modem_tpu_torch" for m in loaded), loaded
        print(len(loaded))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    for surface in ("cli", "native", "compat", "frame.y4m", "utils.debug", "utils.testimages"):
        assert f"color_modem_tpu_torch.{surface}" in port, surface


def _factories():
    from color_modem_tpu_torch.frame import interlace, palplus, svideo, teletext, transcode, video
    from color_modem_tpu_torch.frame import pipeline as pl

    return {
        "make_pipeline": pl.make_pipeline,
        "make_interlaced_pipeline": interlace.make_interlaced_pipeline,
        "make_svideo_pipeline": svideo.make_svideo_pipeline,
        "make_transcoder": transcode.make_transcoder,
        "make_interlaced_transcoder": transcode.make_interlaced_transcoder,
        "synthetic_device_source": video.synthetic_device_source,
        "process_video": video.process_video,
        "make_palplus_pipeline": palplus.make_palplus_pipeline,
        "make_interlaced_palplus_pipeline": palplus.make_interlaced_palplus_pipeline,
        "encode_page": teletext.encode_page,
    }


@pytest.mark.parametrize("name", sorted(_factories()))
def test_factories_default_to_the_card(name):
    """Every entry point runs on the card unless the caller asks for the
    CPU, as the CPU tests do."""
    import inspect

    assert inspect.signature(_factories()[name]).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", ["make_pipeline", "make_interlaced_pipeline",
                                  "make_svideo_pipeline", "make_transcoder",
                                  "synthetic_device_source", "process_video",
                                  "make_palplus_pipeline", "make_interlaced_palplus_pipeline",
                                  "encode_page"])
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
        "make_palplus_pipeline": lambda f: f(make_plan(PAL(), 720)),
        "make_interlaced_palplus_pipeline": lambda f: f(make_plan(PAL(), 720)),
        "encode_page": lambda f: f(make_plan(PAL(), 1440), 1, 0x00, ["ROW"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[name](_factories()[name])
