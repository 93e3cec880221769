"""The port's ``gallery`` verb against the JAX CLI's on the CPU at 64 lines:
the same rows (every standard x every still decoder, S-Video, the RF,
ghost and equalizer rows, the scrambled PAL pair, D2-MAC and PALplus),
each row's PSNR within 0.02 dB and each PNG within 1 code value, the
tape-dropout rows too: their dropouts are JAX's, drawn from the same key
(``utils/prng.py``).
"""

import os

import numpy as np
import pytest

from test_torch_cli import PSNR_TOL, both, png_close
from torch_threads import one_torch_thread  # noqa: F401

#: the rows that draw noise (tape dropouts from ``PRNGKey(7)``)
NOISY = {"ntsc_rf_dropouts", "ntsc_rf_doc"}


def test_gallery_matches_jax(tmp_path):
    pytest.importorskip("PIL")
    out_j, out_t = tmp_path / "j", tmp_path / "t"
    got, want = both(["gallery", "--lines", "64", "--chroma-phase", "20"],
                     ["--out", str(out_j)], ["--out", str(out_t)])
    rows_t, rows_j = got["psnr_db"], want["psnr_db"]
    assert set(rows_t) == set(rows_j) and len(rows_j) == 93
    assert NOISY <= set(rows_j)
    for tag, p in rows_j.items():
        assert abs(rows_t[tag] - p) <= PSNR_TOL, (tag, rows_t[tag], p)
    files = sorted(os.listdir(out_j))
    assert sorted(os.listdir(out_t)) == files
    for f in files:
        if f.endswith(".png"):
            png_close(out_t / f, out_j / f)
    # the dropout compensator repairs what the dropouts broke
    assert rows_t["ntsc_rf_doc"] > rows_t["ntsc_rf_dropouts"] - 1.0
    assert np.isfinite(list(rows_t.values())).all()
