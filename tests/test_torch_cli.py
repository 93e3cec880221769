"""The port's CLI (``python -m color_modem_tpu_torch.cli``) against the JAX
package's (``color_modem_tpu.cli``), both run in-process on the CPU: the
one-frame verbs ``info``, ``encode`` -> ``decode`` through ``--raw``
``.npy``, and ``roundtrip`` for each standard's flagship decoder on
``--pattern scene`` and through the receiver's composable stages, at 64
lines.  ``tests/test_torch_cli_transmission.py`` holds the roundtrips
through the hops and the data services, ``tests/test_torch_cli_video.py``
the other verbs and ``tests/test_torch_cli_gallery.py`` the gallery.

Bounds: the report keys equal the JAX CLI's (only ``backend``, ``device``
and ``seconds`` change values); PSNR to 0.02 dB and SNR to 0.1 dB (the
JAX report prints two decimals); bits, decoded text and flags exact;
image outputs within 1 code value.  Validation errors carry the JAX
CLI's message.  Noisy flags draw the JAX CLI's noise from its keys
(``utils/prng.py``), so those runs are held to the same bounds.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from color_modem_tpu import cli as jcli
from color_modem_tpu_torch import cli as tcli
from torch_threads import one_torch_thread  # noqa: F401

PSNR_TOL, SNR_TOL = 0.02, 0.1
#: report values that differ by design: the backend's name, the device, the
#: host clock
FREE = {"backend", "device", "seconds"}


def run_cli(main, argv):
    """(JSON report of the last stdout line, the other stdout lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), lines[:-1]


def both(argv, jax_extra=(), torch_extra=()):
    """The JAX report and the port's (``--device cpu``) for one argv."""
    want, _ = run_cli(jcli.main, list(argv) + list(jax_extra))
    got, _ = run_cli(tcli.main, list(argv) + ["--device", "cpu"] + list(torch_extra))
    return got, want


def same_report(got, want, path="", free=FREE):
    """Keys equal at every level; numbers that name a dB within their
    bound, everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(
            set(got) ^ set(want)))
        for k in want:
            if k not in free:
                same_report(got[k], want[k], f"{path}.{k}", free)
    elif isinstance(want, list) and want and isinstance(want[0], float):
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            same_report(g, w, f"{path}[{i}]", free)
    elif isinstance(want, float) and not isinstance(want, bool):
        tol = SNR_TOL if "snr" in path else PSNR_TOL if "psnr" in path or path.endswith(
            "_db") else 0.0
        assert abs(got - want) <= tol + 1e-9, (path, got, want)
    else:
        assert got == want, (path, got, want)


def png_close(a, b):
    from PIL import Image

    x = np.asarray(Image.open(a)).astype(int)
    y = np.asarray(Image.open(b)).astype(int)
    assert x.shape == y.shape and np.abs(x - y).max() <= 1


def test_info_matches_jax():
    got, want = run_cli(tcli.main, ["info"])[0], run_cli(jcli.main, ["info"])[0]
    assert set(got) == set(want)
    assert got["standards"] == want["standards"]
    assert got["rf_defaults"] == want["rf_defaults"]
    assert got["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")


def test_encode_then_decode_through_raw_npy(tmp_path):
    from color_modem_tpu_torch.frame.image_io import save_rgb
    from color_modem_tpu_torch.utils.testimages import test_card

    src = str(tmp_path / "in.ppm")
    save_rgb(src, test_card(64, 640).astype(np.float32))  # resampled to 720 on load
    reps = {}
    for tag, main, extra in (("j", jcli.main, []), ("t", tcli.main, ["--device", "cpu"])):
        enc, _ = run_cli(main, ["encode", "--standard", "pal", "--input", src,
                                "--output", str(tmp_path / f"{tag}.png"),
                                "--raw", str(tmp_path / f"{tag}.npy"), *extra])
        dec, _ = run_cli(main, ["decode", "--standard", "pal", "--decoder", "delayline",
                                "--input", str(tmp_path / f"{tag}.npy"),
                                "--output", str(tmp_path / f"{tag}.ppm"), *extra])
        reps[tag] = enc, dec
    for got, want in zip(reps["t"], reps["j"]):
        same_report(got, want, free=FREE | {"output"})
    comp_t, comp_j = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert comp_t.shape == comp_j.shape == (64, 720)
    np.testing.assert_allclose(comp_t, comp_j, atol=2e-5)
    png_close(tmp_path / "t.png", tmp_path / "j.png")
    from color_modem_tpu_torch import native

    d = native.read_ppm(str(tmp_path / "t.ppm")).astype(int)
    assert np.abs(d - native.read_ppm(str(tmp_path / "j.ppm")).astype(int)).max() <= 1


SCENE = ["roundtrip", "--demo", "--pattern", "scene", "--lines", "64"]
FLAGSHIPS = [("ntsc", "comb3"), ("pal", "delayline"), ("secam", "interp"), ("niir", "avg")]


@pytest.mark.parametrize("standard,decoder", FLAGSHIPS, ids=[f"{s}-{d}" for s, d in FLAGSHIPS])
def test_flagship_roundtrip_matches_jax(standard, decoder, tmp_path):
    out_t, out_j = str(tmp_path / "t.ppm"), str(tmp_path / "j.ppm")
    got, want = both(SCENE + ["--standard", standard, "--decoder", decoder],
                     ["--output", out_j], ["--output", out_t])
    same_report(got, want, free=FREE | {"output"})
    assert got["backend"] == "kernel" and got["device"] == "cpu"
    from color_modem_tpu_torch import native

    d = native.read_ppm(out_t).astype(int) - native.read_ppm(out_j).astype(int)
    assert np.abs(d).max() <= 1


COMPOSED = {
    # receiver loops under a channel: burst lock with ACC, PAL ident
    "burst-locked": ["--standard", "ntsc", "--decoder", "comb3", "--raster", "--burst-locked",
                     "--chroma-phase", "25", "--chroma-gain", "0.7", "--acc"],
    "pal-ident-caption": ["--standard", "pal", "--decoder", "comb3", "--raster",
                          "--burst-locked", "--pal-ident", "--caption", "HELLO"],
    "vir": ["--standard", "ntsc", "--decoder", "comb3", "--vir", "--chroma-phase", "20",
            "--diff-gain", "0.1"],
    "secam-ident": ["--standard", "secam", "--decoder", "interp", "--secam-ident", "--raster"],
    "tbc-vhs": ["--standard", "ntsc", "--decoder", "comb3", "--raster", "--tbe-us", "0.1",
                "--tbc", "--vhs"],
    "interlaced-shuffle": ["--standard", "pal", "--decoder", "comb3", "--interlaced",
                           "--scramble", "shuffle"],
    "svideo": ["--standard", "ntsc", "--svideo"],
    "palplus": ["--standard", "pal", "--decoder", "comb3", "--palplus"],
}


@pytest.mark.parametrize("case", sorted(COMPOSED))
def test_composed_roundtrip_matches_jax(case):
    got, want = both(SCENE + COMPOSED[case])
    same_report(got, want)


ERRORS = {
    "temporal": (["roundtrip", "--demo", "--decoder", "comb3d"], "temporal decoder"),
    "secam-burst": (["roundtrip", "--demo", "--standard", "secam", "--decoder", "interp",
                     "--burst-locked", "--raster"], "no color burst"),
    "pal-ident-ntsc": (["roundtrip", "--demo", "--pal-ident", "--burst-locked", "--raster"],
                       "PAL-family feature"),
    "tbc-raster": (["roundtrip", "--demo", "--tbc"], "need --raster"),
    "svideo-rf": (["roundtrip", "--demo", "--svideo", "--rf"], "--svideo does not combine"),
    "a2-nicam": (["roundtrip", "--demo", "--lines", "64", "--rf-a2", "stereo", "--rf-nicam"],
                 "cannot share a channel"),
    "sat-rf": (["roundtrip", "--demo", "--lines", "64", "--satellite", "--rf"],
               "pick one"),
    "palplus-vhs": (["roundtrip", "--demo", "--lines", "64", "--palplus", "--vhs"],
                    "remove --vhs"),
    "teletext-width": (["roundtrip", "--demo", "--lines", "64", "--teletext", "A"],
                       "width >= 1440"),
    "wss-aspect": (["roundtrip", "--demo", "--lines", "64", "--wss", "bogus"], "unknown aspect"),
    "vitc-format": (["roundtrip", "--demo", "--lines", "64", "--vitc", "1:2"], "HH:MM:SS:FF"),
    "scramble-equalize": (["roundtrip", "--demo", "--lines", "64", "--scramble", "cutrotate",
                           "--equalize"], "does not combine with --equalize"),
    "agc-raster": (["roundtrip", "--demo", "--lines", "64", "--rf-agc"], "--rf-agc needs"),
    "audio-out": (["roundtrip", "--demo", "--lines", "64", "--audio-out", "x.wav", "--rf"],
                  "needs a sound transmission"),
    "mac-payloads": (["mac", "--demo", "--lines", "64", "--audio-in", "x.wav", "--data", "A"],
                     "share the burst"),
    "transcode-input": (["transcode", "--from", "ntsc", "--to", "pal"], "--input or --demo"),
    "video-audio": (["video", "--out", "x", "--frames", "2", "--lines", "32", "--rf-stereo"],
                    "add --rf"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_validation_errors_match_jax(case, tmp_path, monkeypatch):
    argv, needle = ERRORS[case]
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as ej:
        jcli.main(list(argv))
    with pytest.raises(SystemExit) as et:
        tcli.main(list(argv) + ["--device", "cpu"])
    assert needle in str(ej.value)
    assert str(et.value) == str(ej.value)


def test_noisy_roundtrip_repeats_itself():
    """The noise is the JAX CLI's, from the same keys (composite noise,
    RF noise and tape dropouts): the report equals the JAX CLI's at the
    clean bounds (PSNR to 0.02 dB), and a second run reads the same
    report."""
    argv = SCENE + ["--standard", "pal", "--decoder", "comb3", "--noise", "0.02", "--rf",
                    "--rf-noise", "0.01", "--rf-dropouts", "0.05", "--rf-doc"]
    one, want = both(argv)
    two, _ = run_cli(tcli.main, argv + ["--device", "cpu"])
    assert {k: v for k, v in one.items() if k != "seconds"} == \
        {k: v for k, v in two.items() if k != "seconds"}
    same_report(one, want)
    assert abs(one["psnr_db"] - want["psnr_db"]) <= PSNR_TOL, (one["psnr_db"], want["psnr_db"])


def test_default_device_is_the_card(monkeypatch):
    """Without --device the verbs run on the card; without CUDA they raise
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (SCENE, ["transcode", "--from", "ntsc", "--to", "pal", "--demo"],
                 ["measure", "--lines", "32"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(argv)
    assert tcli.build_parser().parse_args(SCENE).device == "cuda"
