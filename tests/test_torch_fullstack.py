"""The full-stack 625-line broadcast through the PyTorch port
(``scripts/torch_fullstack.py``) against the JAX package's CLI
(``tests/test_fullstack.py``'s flags) on the CPU, at its 64-line size:
interlaced, rastered PAL at 1440 samples; captions, teletext, WSS and VITC;
cut-and-rotate scrambling of the active picture; the RF hop with FM mono
sound and NICAM-728, or with A2 stereo.

Bounds: every service decodes exactly, as the JAX run does; the picture
PSNR and the pirate's PSNR equal the CLI's to 0.02 dB (it prints two
decimals); the sound SNRs to 0.1 dB (phase 4h's bound); the subscriber
stands more than 10 dB above the pirate.  A2 and NICAM together are
refused, as the CLI refuses them.
"""

import contextlib
import io
import json
import os
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_fullstack  # noqa: E402

from color_modem_tpu.cli import main as jax_cli  # noqa: E402
from test_fullstack import FULL_FLAGS  # noqa: E402

PSNR_TOL, SNR_TOL = 0.02, 0.1


def _jax_report(extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_cli(FULL_FLAGS + extra) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _same_services(rep, want):
    for name in ("caption", "teletext", "wss", "vitc"):
        assert rep[name]["exact"] and want[name]["exact"], (name, rep[name], want[name])
    for name in ("caption", "wss", "vitc"):
        assert rep[name]["received"] == want[name]["received"], name
    assert rep["teletext"]["rows"] == want["teletext"]["rows"]
    assert rep["caption"]["parity_ok"] and rep["teletext"]["parity_ok"]
    assert rep["teletext"]["address_ok"] and rep["vitc"]["crc_ok"]
    assert rep["vitc"]["sync_score"] == want["vitc"]["sync_score"]
    assert abs(rep["psnr_db"] - want["psnr_db"]) <= PSNR_TOL, (rep["psnr_db"], want["psnr_db"])
    pirate, pirate_j = rep["scramble"]["pirate_psnr_db"], want["scramble"]["pirate_psnr_db"]
    assert abs(pirate - pirate_j) <= PSNR_TOL, (pirate, pirate_j)
    assert rep["psnr_db"] - pirate > 10.0
    assert rep["psnr_db"] > 28.0  # tests/test_fullstack.py


def test_full_stack_nicam_matches_jax():
    rep = torch_fullstack.full_stack(nicam=True, lines=64, device="cpu")
    want = _jax_report(["--rf-nicam"])
    _same_services(rep, want)
    assert abs(rep["rf"]["audio_snr_db"] - want["rf"]["audio_snr_db"]) <= SNR_TOL
    nic, nic_j = rep["rf"]["nicam"], want["rf"]["nicam"]
    assert nic["frames"] == nic_j["frames"] and nic["parity_errors"] == 0 and nic["faw_ok"]
    for side in ("left_snr_db", "right_snr_db"):
        assert abs(nic[side] - nic_j[side]) <= SNR_TOL, side


def test_full_stack_a2_matches_jax():
    rep = torch_fullstack.full_stack(a2=True, lines=64, device="cpu")
    want = _jax_report(["--rf-a2", "stereo"])
    _same_services(rep, want)
    a2, a2_j = rep["rf"]["a2"], want["rf"]["a2"]
    assert a2["mode_detected"] == a2_j["mode_detected"] == "stereo"
    for side in ("left_snr_db", "right_snr_db"):
        assert abs(a2[side] - a2_j[side]) <= SNR_TOL, side


def test_a2_plus_nicam_refused():
    with pytest.raises(ValueError, match="cannot share a channel"):
        torch_fullstack.full_stack(nicam=True, a2=True, lines=64, device="cpu")
