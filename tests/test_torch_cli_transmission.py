"""The port's CLI ``roundtrip`` through the RF hop and its sound carriers,
the in-service test lines and the data services at 1440 samples, against
the JAX CLI on the CPU at 64 lines (``tests/test_torch_cli_video.py``
holds the satellite hop), at ``tests/test_torch_cli.py``'s bounds: report
keys equal, PSNR 0.02 dB, SNR 0.1 dB, decoded services exact."""

import pytest

from test_torch_cli import SCENE, both, same_report
from torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "vits-ghost-equalize": ["--standard", "ntsc", "--decoder", "comb3", "--vits",
                            "--ghost-delay-us", "2", "--ghost-gain", "0.2", "--equalize"],
    "rf-audio-aft": ["--standard", "ntsc", "--decoder", "comb3", "--rf", "--rf-audio",
                     "--rf-phase-error", "30", "--rf-freq-error", "2000", "--rf-aft"],
    "rf-stereo-agc": ["--standard", "ntsc", "--decoder", "comb3", "--raster", "--rf-stereo",
                      "--rf-gain", "0.5", "--rf-agc"],
    "rf-ghost-equalize-a2": ["--standard", "pal", "--decoder", "comb3", "--rf-a2", "stereo",
                             "--rf-ghost-gain", "0.3", "--rf-equalize"],
    "services-1440": ["--standard", "pal", "--decoder", "comb3", "--width", "1440",
                      "--raster", "--interlaced", "--teletext", "FULL STACK|ROW TWO",
                      "--wss", "16:9 full (anamorphic)", "--vitc", "01:02:03:04",
                      "--caption", "CAPTIONS"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transmission_roundtrip_matches_jax(case):
    got, want = both(SCENE + CASES[case])
    same_report(got, want)
    for svc in ("caption", "teletext", "wss", "vitc"):
        if svc in want:
            assert got[svc]["exact"] and want[svc]["exact"], svc
