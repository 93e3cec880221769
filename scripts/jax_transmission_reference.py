"""The JAX package's values that ``chip_smoke.py`` phases 4g and 6 hold the
PyTorch port's transmission layer to, computed by the JAX ``xla`` path on
the CPU at the card's shapes.  Run from the repository root:

    JAX_PLATFORMS=cpu python3 scripts/jax_transmission_reference.py [--only NAME ...]

Prints one JSON object per row as it finishes.  Rows:

* ``rf-vsb-hop``: NTSC composite (notch encode of ``smooth_scene(480, 720,
  seed=0)`` broadcast to 16 frames) through ``rf_roundtrip``: transparency
  over lines [2:-2], as ``scripts/chip_matrix_r02.py`` measures it;
* ``satellite-fm-hop``: the same composite through ``fm_modulate`` ->
  ``fm_demodulate``;
* ``d2mac``: the MAC round trip of ``smooth_scene(576, 720, seed=0)`` x 16,
  absolute lines ``b*625 + l``;
* ``mac-satellite``: those MAC lines through the satellite hop
  (``make_sat_plan(20.25e6, 1296)``), transparency;
* ``rf-ghost-gcr``: the rf-vsb-hop composite through an RF ghost (3 us,
  gain 0.3), then the GCR equalizer (guarded record through the same
  chain, 1281 taps, reg 1e-4, pivot ``video_zero``): PSNR before and after,
  and after with the same design done in float64 NumPy;
* ``tbc``: rastered NTSC comb3 of ``smooth_scene(480, 720, seed=0)`` x 16,
  0.3 us wobble, then ``tbc_correct``: RGB PSNR clean, wrecked, fixed;
* ``video-rf`` / ``video-satellite``: ``process_video`` NTSC comb3 on
  ``synthetic_device_source(480, 720, seed=0)``, 48 frames in chunks of 16,
  with ``rf=True`` / ``satellite=True, sat_cnr=12.0``: ``min_psnr_db``.

This script imports JAX; the port and ``chip_smoke.py`` do not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, N = 16, 720


def _composite():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC
    from color_modem_tpu.utils.testimages import smooth_scene

    plan = make_plan(NTSC(), N)
    rgb = jnp.asarray(np.broadcast_to(smooth_scene(480, N, seed=0), (B, 3, 480, N)),
                      jnp.float32)
    enc, _, _ = make_pipeline(plan, "notch", "xla")
    return plan, np.asarray(enc(rgb, 0))


def row_rf():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.rf import make_rf_plan, rf_roundtrip
    from color_modem_tpu.utils.metrics import psnr

    plan, comp = _composite()
    out = np.asarray(rf_roundtrip(make_rf_plan(plan), jnp.asarray(comp), 0))
    return {"transparency_db": psnr(out[:, 2:-2], comp[:, 2:-2])}


def row_satellite():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame import satellite as sat
    from color_modem_tpu.utils.metrics import psnr

    plan, comp = _composite()
    sp = sat.make_sat_plan(plan.fs, N)
    out = np.asarray(sat.fm_demodulate(sp, sat.fm_modulate(sp, jnp.asarray(comp))))
    return {"transparency_db": psnr(out, comp)}


def _mac():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.modem import mac
    from color_modem_tpu.utils.testimages import smooth_scene

    mplan = mac.make_mac_plan(N)
    rgb = jnp.asarray(np.broadcast_to(smooth_scene(576, N, seed=0), (B, 3, 576, N)),
                      jnp.float32)
    g = jnp.arange(B)[:, None] * mplan.cfg.total_lines + jnp.arange(576)
    return mac, mplan, rgb, g


def row_d2mac():
    import numpy as np

    from color_modem_tpu.utils.metrics import psnr

    mac, mplan, rgb, g = _mac()
    return {"psnr_db": psnr(np.asarray(mac.roundtrip(mplan, rgb, g)), np.asarray(rgb))}


def row_mac_satellite():
    import numpy as np

    from color_modem_tpu.frame import satellite as sat
    from color_modem_tpu.utils.metrics import psnr

    mac, mplan, rgb, g = _mac()
    sig = mac.encode(mplan, rgb, g)
    sp = sat.make_sat_plan(mplan.cfg.fs, mplan.cfg.samples_per_line)
    rx = np.asarray(sat.fm_demodulate(sp, sat.fm_modulate(sp, sig)))
    return {"transparency_db": psnr(rx, np.asarray(sig)),
            "picture_db": psnr(np.asarray(mac.decode(mplan, rx, g)), np.asarray(rgb))}


def row_rf_ghost():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.equalize import (
        apply_equalizer,
        design_equalizer,
        gcr_record_guarded,
    )
    from color_modem_tpu.frame.rf import make_rf_plan, rf_demodulate, rf_ghost, rf_modulate
    from color_modem_tpu.utils.metrics import psnr

    plan, comp = _composite()
    rfp = make_rf_plan(plan)

    def chain(c):
        return np.asarray(rf_demodulate(rfp, rf_ghost(rfp, rf_modulate(rfp, jnp.asarray(c), 0),
                                                      3.0, 0.30), 0))

    ghosted = chain(comp)
    pv = rfp.video_zero
    rx = chain(gcr_record_guarded(plan)[None])[0][:3]
    taps = design_equalizer(plan, jnp.asarray(rx), ntaps=1281, reg=1e-4, pivot=pv)
    eq = np.asarray(apply_equalizer(jnp.asarray(ghosted), taps, pivot=pv))
    # the same ridge design in float64 NumPy: at reg 1e-4 the equalized
    # PSNR moves by ~0.1 dB with the float32 rounding of the design
    from color_modem_tpu.dsp.design import tukey
    from color_modem_tpu.frame.equalize import gcr_line

    r = rx[1:].reshape(-1).astype(np.float64) - pv
    s = gcr_line(plan, r.shape[-1]).astype(np.float64) - pv
    S, R = np.fft.rfft(s), np.fft.rfft(r)
    ps2 = np.abs(S) ** 2
    den = ps2 + 1e-4 * ps2.mean()
    H = R * np.conj(S) / den + (1.0 - ps2 / den)
    e = np.fft.irfft(np.conj(H) / (np.abs(H) ** 2 + 1e-4 * np.mean(np.abs(H) ** 2)),
                     n=r.shape[-1])
    t64 = np.concatenate([e[-640:], e[:641]]) * tukey(1281, alpha=0.4)
    eq64 = np.asarray(apply_equalizer(jnp.asarray(ghosted), jnp.asarray(t64, jnp.float32),
                                      pivot=pv))
    return {"ghosted_db": psnr(ghosted[:, 2:-2], comp[:, 2:-2]),
            "equalized_db": psnr(eq[:, 2:-2], comp[:, 2:-2]),
            "equalized_f64_design_db": psnr(eq64[:, 2:-2], comp[:, 2:-2])}


def row_tbc():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu.frame.raster import make_raster
    from color_modem_tpu.frame.timebase import impair_timebase, tbc_correct
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC
    from color_modem_tpu.utils.metrics import psnr
    from color_modem_tpu.utils.testimages import smooth_scene

    plan = make_plan(NTSC(), N)
    rgb = np.broadcast_to(smooth_scene(480, N, seed=0), (B, 3, 480, N)).astype(np.float32)
    enc, dec, _ = make_pipeline(plan, "comb3", "xla", raster=True)
    ras = enc(jnp.asarray(rgb), 0)
    shifted, _ = impair_timebase(plan, ras, wobble_us=0.3)
    fixed = tbc_correct(plan, make_raster(plan), shifted, frame_line_index(plan, 0, B, 480))
    return {name: psnr(np.asarray(dec(x, 0)), rgb)
            for name, x in (("clean_db", ras), ("wrecked_db", shifted), ("fixed_db", fixed))}


def _video(**kw):
    from color_modem_tpu.frame.video import process_video, synthetic_device_source
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC

    with tempfile.TemporaryDirectory() as d:
        s = process_video(make_plan(NTSC(), N), synthetic_device_source(480, N, seed=0), 48, d,
                          decoder="comb3", chunk=16, backend="xla", **kw)
    return {"min_psnr_db": s["min_psnr_db"]}


ROWS = {
    "rf-vsb-hop": row_rf,
    "satellite-fm-hop": row_satellite,
    "d2mac": row_d2mac,
    "mac-satellite": row_mac_satellite,
    "rf-ghost-gcr": row_rf_ghost,
    "tbc": row_tbc,
    "video-rf": lambda: _video(rf=True),
    "video-satellite": lambda: _video(satellite=True, sat_cnr=12.0),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", choices=sorted(ROWS), default=None)
    args = ap.parse_args()
    import jax

    for name in args.only or ROWS:
        t0 = time.perf_counter()
        res = ROWS[name]()
        print(json.dumps({"row": name, "backend": jax.default_backend(), **res,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
