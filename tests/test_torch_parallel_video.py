"""The port's video runner over a rank mesh: ``process_video(mesh=)``
(``color_modem_tpu_torch/frame/video.py``) on 2 CPU gloo ranks, against the
same run unsharded.

Each run goes on a (2,1) and a (1,2) mesh: NTSC comb3 progressive and
interlaced, comb3d with NR (chunks widened with true frames to the frame
axis, two frames per rank), the RF hop with captions and scrambling, the
RF hop with a soundtrack progressive and interlaced (the chunk's stream
split over the rank ring, one item of RF from each neighbour), and comb3dA
through the noisy satellite hop and a ghosted, noisy, equalized channel:
the stages that act on whole frames, each rank transmitting its share of
the chunk.  The saved frames, the received audio, the caption cells and
the PSNR equal the unsharded runner's (the sharded QAM codec and the
frame-local stages are bit-identical on the CPU; the audio to
``AUDIO_ATOL``); only rank 0 returns a summary, and its output directory
holds the files of the unsharded run; the manifest records the mesh, a
resume with the same mesh processes nothing and one with another mesh is
refused, as is a ``device`` other than the mesh's.
"""

import json
import os

import numpy as np
import pytest

from color_modem_tpu_torch import NTSC
from color_modem_tpu_torch.frame.video import process_video, synthetic_source
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.parallel import multihost as mh
from torch_threads import one_torch_thread  # noqa: F401

L, N, FRAMES = 32, 720, 7
CAPTIONS = np.random.default_rng(5).integers(0, 2, (FRAMES, 16)).tolist()
RUNS = {
    "comb3": dict(decoder="comb3", chunk=3),
    "comb3-interlaced": dict(decoder="comb3", chunk=3, interlaced=True),
    "comb3d-nr": dict(decoder="comb3d", chunk=3, nr=True, nr_sigma=0.02),
    "rf-services": dict(decoder="comb3", chunk=4, rf=True, caption_bits=CAPTIONS,
                        scramble=["cutrotate", 77]),
    "rf-audio": dict(decoder="comb3", chunk=3, rf=True, rf_audio="tones"),
    "rf-audio-interlaced": dict(decoder="comb3", chunk=4, rf=True, rf_audio="tones",
                                interlaced=True),
    "comb3dA-sat-channel": dict(decoder="comb3dA", chunk=3, satellite=True, sat_cnr=25.0,
                                channel={"noise_sigma": 0.01, "ghost_delay_us": 0.8,
                                         "ghost_gain": 0.1, "equalize": True}),
}
MESHES = [(2, 1), (1, 2)]
#: the runs that the mesh moves, at the JAX gate's bounds for their hop
#: (the others bit-identical).  Measured: the soundtrack's 6.7e-7 on the
#: audio and 6.6e-7 on the frames (7.5e-7 and 7.2e-7 interlaced), each
#: rank's carrier phase starting from the track's float64 prefix, not from
#: a running sum over the frames before it; the satellite hop's 2.5e-5,
#: its FFTs on a batch of another size (the unsharded runner at chunk 7
#: against chunk 3 differs by the same 2.5e-5); "sat-channel"'s PSNRs are
#: held to the rounding of the summary's 0.01 dB.
ATOL = {"rf-audio": {"rgb": 2e-5, "aud": 1e-5},
        "rf-audio-interlaced": {"rgb": 2e-5, "aud": 1e-5},
        "comb3dA-sat-channel": {"rgb": 1e-3}}


def _cases():
    cases = []
    for run, opts in RUNS.items():
        for ms in MESHES:
            name = f"{run}@{ms[0]}x{ms[1]}"
            cases.append({"name": name, "kind": "video", "mesh": list(ms), "standard": "ntsc",
                          "out": name, "backend": "plain",
                          "opts": dict(opts, n_frames=FRAMES, lines=L)})
    first = dict(cases[0], name="resume-first-run", out="resume")
    again = dict(first, name="resume-same-mesh")
    other = dict(first, name="resume-other-mesh", mesh=[1, 2], expect_error=True)
    device = dict(first, name="other-device", out="device", expect_error=True,
                  opts=dict(first["opts"], device="meta"))
    return cases + [first, again, other, device]


CASES = _cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("video_ranks")
    recs = mh.launch(CASES, 2, backend="gloo", device="cpu", outdir=str(out), timeout=600.0)
    return out, recs


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    runs = {}
    for run, opts in RUNS.items():
        d = tmp_path_factory.mktemp(run)
        opts = dict(opts)
        if "scramble" in opts:
            opts["scramble"] = tuple(opts["scramble"])
        if "rf_audio" in opts:
            opts["rf_audio"] = mh.sound_fixture(make_plan(NTSC(), N).fs, FRAMES, L).reshape(-1)
        s = process_video(make_plan(NTSC(), N), synthetic_source(L, N), FRAMES, str(d),
                          backend="plain", device="cpu", save_outputs=True, **opts)
        runs[run] = (d, s)
    return runs


def _fp(hexed):
    return np.frombuffer(bytes.fromhex(hexed), "<f4")


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs
                  if not f.startswith("run_"))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("run", list(RUNS))
def test_mesh_run_equals_unsharded(run, mesh_shape, ranks, unsharded):
    out, recs = ranks
    name = f"{run}@{mesh_shape[0]}x{mesh_shape[1]}"
    r0 = next(r for r in recs[0] if r["name"] == name)
    r1 = next(r for r in recs[1] if r["name"] == name)
    d_u, s_u = unsharded[run]
    d_s, s_s = out / name, r0["summary"]
    assert r1["summary"] is None  # only rank 0 reports
    assert s_s["mesh"] == {"frame": mesh_shape[0], "lineblk": mesh_shape[1]}
    atol = ATOL.get(run)
    db = 0.01 if atol else 0.0
    assert abs(s_s["min_psnr_db"] - s_u["min_psnr_db"]) <= db
    assert s_s["frames_processed_this_run"] == FRAMES
    assert _files(d_s) == _files(d_u)
    assert len(os.listdir(d_s / "results")) == 1
    for f in _files(d_u):
        if not f.endswith(".npy"):
            continue
        got, want = np.load(d_s / f), np.load(d_u / f)
        if atol and f[:3] in atol:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol[f[:3]], err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    manifest = json.loads((d_s / "manifest.json").read_text())
    assert manifest["config"]["mesh"] == s_s["mesh"]
    want = json.loads((d_u / "manifest.json").read_text())["chunks"]
    assert manifest["chunks"].keys() == want.keys()
    for key, rec in manifest["chunks"].items():
        assert abs(rec["psnr"] - want[key]["psnr"]) <= db
        # the fingerprint's dot products sum in an order that follows the
        # process's thread count (a rank runs one thread): equal frames,
        # fingerprints equal to float32 rounding.  Frames within `atol`:
        # each of the fingerprint's weights is at most 1 and each pixel
        # in [0, 1], so it moves by at most 2 * atol per pixel
        start, end = (int(v) for v in key.split("-"))
        slack = 2 * atol["rgb"] * (end - start) * 3 * L * N if atol else 0.0
        np.testing.assert_allclose(_fp(rec["fp"]), _fp(want[key]["fp"]), rtol=1e-5,
                                   atol=slack)


def test_a_device_other_than_the_mesh_s_is_refused(ranks):
    _, recs = ranks
    for rr in recs:
        r = next(r for r in rr if r["name"] == "other-device")
        assert "is not the mesh's device cpu" in r["error"]


def test_resume_with_the_same_mesh_skips_and_another_is_refused(ranks):
    _, recs = ranks
    for rr in recs:
        same = next(r for r in rr if r["name"] == "resume-same-mesh")
        other = next(r for r in rr if r["name"] == "resume-other-mesh")
        assert "refusing to resume" in other["error"]
        assert "'lineblk': 2" in other["error"]
        if same["rank"] == 0:
            assert same["summary"]["frames_processed_this_run"] == 0
