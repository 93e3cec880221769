"""The port's rank meshes beyond the 4-rank tests, from the command line, on
CPU ranks over gloo.

* The multi-chip gate's case list on 8 ranks at (2,4), the JAX gate's
  device count: ``python -m color_modem_tpu_torch.parallel.multihost
  --num-processes 8 --backend gloo --device cpu --mesh 2x4``, every case
  within its bound against the unsharded pipeline (QAM bit-identical;
  ``multihost.py`` sets each case's bound).
* ``cli video --mesh 2x2`` on 4 ranks under ``python -m
  torch.distributed.run``: rank 0 alone prints the report and writes the
  clip, and the frames equal the unsharded CLI run's bit for bit (4 frames
  x 64 lines, NTSC comb3, the QAM bound).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv, timeout):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, *argv], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    return [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]


def test_gate_case_list_on_8_ranks(tmp_path):
    recs = _run(["-m", "color_modem_tpu_torch.parallel.multihost", "--num-processes", "8",
                 "--backend", "gloo", "--device", "cpu", "--mesh", "2x4",
                 "--outdir", str(tmp_path)], timeout=400)
    assert len(recs) == 26, [r["name"] for r in recs]
    for r in recs:
        video_bound, audio_bound = r["bound"] if isinstance(r["bound"], list) else (r["bound"],) * 2
        for k, e in r["err"].items():
            assert e <= (audio_bound if k == "aud" else video_bound), r["name"]
        assert r["devices"] == ["cpu"] * 8, r["name"]
        kind, path = r["name"].split(":")
        if kind in ("pipeline", "interlaced") and not path.startswith("secam"):
            assert max(r["err"].values()) == 0.0, r["name"]  # QAM: bit-identical
    names = {r["name"] for r in recs}
    assert {"pipeline:ntsc/comb3@2x4", "pipeline:ntsc/comb3@1x8",
            "pipeline:secam/interp@2x4", "pipeline:pal/delayline@8x1"} <= names


def _frames(d):
    return np.concatenate([np.load(f) for f in sorted(glob.glob(os.path.join(d, "rgb_*.npy")))])


def test_cli_video_mesh_2x2_under_torchrun(tmp_path):
    video = ["-m", "color_modem_tpu_torch.cli", "video", "--standard", "ntsc", "--decoder",
             "comb3", "--frames", "4", "--lines", "64", "--chunk", "4", "--device", "cpu"]
    mesh = _run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                 *video, "--mesh", "2x2", "--out", str(tmp_path / "mesh"),
                 "--output", str(tmp_path / "mesh.y4m")], timeout=400)
    one = _run([*video, "--out", str(tmp_path / "one"), "--output", str(tmp_path / "one.y4m")],
               timeout=200)
    assert len(mesh) == 1 and len(one) == 1  # rank 0 alone reports
    got, want = mesh[0], one[0]
    assert got["mesh"] == {"frame": 2, "lineblk": 2} and want["mesh"] is None
    assert got["min_psnr_db"] == want["min_psnr_db"] and got["output_frames"] == 4
    assert np.array_equal(_frames(tmp_path / "mesh"), _frames(tmp_path / "one"))
    assert (tmp_path / "mesh.y4m").read_bytes() == (tmp_path / "one.y4m").read_bytes()
