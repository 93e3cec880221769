"""The port's CLI verbs ``video``, ``transcode``, ``mac`` and ``measure``,
and ``roundtrip`` through the satellite hop, against the JAX CLI on the
CPU, at ``tests/test_torch_cli.py``'s bounds:
report keys equal, PSNR 0.02 dB, decoded captions and data exact, image
and clip outputs within 1 code value.

``video`` reads a 6-frame 64x720 ``.y4m`` clip written by the port's
``write_y4m`` (``--input``), decodes it in chunks of 4 and writes the
decoded clip (``--output``), with and without ``--caption``.
"""

import contextlib
import io

import numpy as np
import pytest

from color_modem_tpu_torch.frame.y4m import write_y4m, y4m_source
from color_modem_tpu_torch.utils.testimages import smooth_scene
from test_torch_cli import FREE, SCENE, both, jcli, png_close, run_cli, same_report, tcli
from torch_threads import one_torch_thread  # noqa: F401

FRAMES, LINES, N = 6, 64, 720


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.y4m")
    frames = np.stack([np.roll(smooth_scene(LINES, N, seed=0), 8 * i, axis=2)
                       for i in range(FRAMES)]).astype(np.float32)
    assert write_y4m(path, [frames]) == FRAMES
    return path


@pytest.mark.parametrize("extra", [[], ["--caption", "HELLO"]], ids=["plain", "caption"])
def test_video_y4m_in_and_out_matches_jax(clip, extra, tmp_path):
    argv = ["video", "--standard", "ntsc", "--decoder", "comb3", "--input", clip,
            "--chunk", "4", *extra]
    got, want = both(argv, ["--out", str(tmp_path / "j"), "--output", str(tmp_path / "j.y4m")],
                     ["--out", str(tmp_path / "t"), "--output", str(tmp_path / "t.y4m")])
    same_report(got, want, free=FREE | {"output", "mpix_per_s"})
    assert got["output_frames"] == got["n_frames"] == FRAMES
    if extra:
        assert got["caption"]["exact"] and got["caption"]["received"] == "HELLO"
    src_t, n, h, w = y4m_source(str(tmp_path / "t.y4m"))
    src_j, *_ = y4m_source(str(tmp_path / "j.y4m"))
    assert (n, h, w) == (FRAMES, LINES, N)
    # within one 8-bit code value: 1/219 of luma, 1/224 of chroma, through
    # the BT.601 matrix
    assert np.abs(src_t(0, n) - src_j(0, n)).max() <= 2.1 / 219


def test_video_resumes_and_reports_like_jax(tmp_path):
    """A synthetic run (the host source) in two calls: the second resumes
    and processes nothing, as the JAX runner's does."""
    argv = ["video", "--standard", "pal", "--decoder", "delayline", "--frames", "4",
            "--lines", "32", "--chunk", "2", "--host-source"]
    got, want = both(argv, ["--out", str(tmp_path / "j")], ["--out", str(tmp_path / "t")])
    same_report(got, want, free=FREE | {"mpix_per_s"})
    again, _ = run_cli(tcli.main, argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert again["frames_processed_this_run"] == 0


def test_transcode_matches_jax(tmp_path):
    got, want = both(["transcode", "--from", "ntsc", "--to", "pal", "--demo"],
                     ["--composite", str(tmp_path / "j.png")],
                     ["--composite", str(tmp_path / "t.png")])
    same_report(got, want, free=FREE | {"composite"})
    png_close(tmp_path / "t.png", tmp_path / "j.png")


def _text(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().strip().splitlines()


def test_mac_matches_jax(tmp_path):
    """The mac verb prints lines of text (PSNR to one decimal, the sync
    count, the payload): the same lines, the output path aside."""
    argv = ["mac", "--demo", "--lines", "64", "--data", "HELLO MAC", "--satellite"]
    lines_j = _text(jcli.main, argv + ["--output", str(tmp_path / "j.ppm")])
    lines_t = _text(tcli.main, argv + ["--output", str(tmp_path / "t.ppm"), "--device", "cpu"])
    assert lines_t[:-1] == lines_j[:-1]
    assert "'HELLO MAC'" in lines_t[-2] and "ber 0.00e+00" in lines_t[-2]
    from color_modem_tpu_torch import native

    d = native.read_ppm(str(tmp_path / "t.ppm")).astype(int)
    assert np.abs(d - native.read_ppm(str(tmp_path / "j.ppm")).astype(int)).max() <= 1


@pytest.mark.parametrize("standard", ["ntsc", "secam"])
def test_measure_matches_jax(standard, tmp_path):
    argv = ["measure", "--standard", standard, "--lines", "64", "--pulse-bar",
            "--chroma-phase", "10", "--diff-gain", "0.1"]
    # the vectorscope and the spectrum analyzer read a QAM subcarrier
    images = ("waveform",) + (("vectorscope", "spectrum") if standard == "ntsc" else ())

    def pngs(side):
        return [a for k in images for a in (f"--{k}", str(tmp_path / f"{side}{k}.png"))]

    got, want = both(argv, pngs("j"), pngs("t"))
    from PIL import Image

    for k in images:  # the instrument displays: rendered, at the JAX CLI's size
        assert got.pop(k) != want.pop(k)
        assert Image.open(tmp_path / f"t{k}.png").size == Image.open(tmp_path / f"j{k}.png").size
    # the readings print 2-4 decimals; a delay near zero may differ in the
    # last one
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v)
            for kk, vv in v.items():
                assert abs(got[k][kk] - vv) <= 0.02, (k, kk, got[k][kk], vv)
        elif isinstance(v, list):
            np.testing.assert_allclose(got[k], v, atol=0.02)
        elif isinstance(v, float):
            assert abs(got[k] - v) <= 0.002, (k, got[k], v)
        else:
            assert got[k] == v, k


def test_satellite_roundtrip_matches_jax():
    """The FM satellite hop with an audio subcarrier, carrying a scrambled
    picture."""
    got, want = both(SCENE + ["--standard", "pal", "--decoder", "comb3", "--satellite",
                              "--sat-audio", "--scramble", "cutrotate"])
    same_report(got, want)
