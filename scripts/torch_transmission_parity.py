"""The PyTorch port's transmission layer against the JAX package and the
frozen naive chains of ``golden/``, on the CPU (this script imports both
packages; the card has no JAX).  Run from the repository root:

    JAX_PLATFORMS=cpu python3 scripts/torch_transmission_parity.py

Prints one JSON object per row, on the 2 x 16 x 720 NTSC notch composite
of tests/test_golden_transmission.py:

* ``fm_modulate``: parity (dB) of the port's and of the JAX package's FM
  signal against ``golden/transmission.py``, and of the two against each
  other;
* ``sat_roundtrip``: max |diff| of the port's hop against the JAX
  package's, and of a two-frame batch against its second frame alone;
* ``rf``: the same parities for ``rf_modulate`` / ``rf_demodulate``;
* ``equalizer``: max |diff| of the port's designed taps against the JAX
  package's (RF ghost 3 us / 0.3 through the RF hop, guarded record, 1281
  taps, reg 1e-4, pivot ``video_zero``).
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parity_db(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(10.0 * np.log10(np.var(b) / max(np.mean((a - b) ** 2), 1e-300)))


def main() -> None:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from color_modem_tpu.frame import equalize as jeq
    from color_modem_tpu.frame import rf as jrf
    from color_modem_tpu.frame import satellite as jsat
    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.golden import transmission as gt
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC
    from color_modem_tpu.utils.testimages import smooth_scene
    from color_modem_tpu_torch.frame import equalize as teq
    from color_modem_tpu_torch.frame import rf as trf
    from color_modem_tpu_torch.frame import satellite as tsat
    from color_modem_tpu_torch.modem.plan import plan_from_numpy

    plan = make_plan(NTSC(), 720)
    tplan = plan_from_numpy(plan)
    rgb = np.stack([smooth_scene(16, 720, seed=s) for s in (0, 1)]).astype(np.float32)
    comp = np.asarray(make_pipeline(plan, "notch")[0](jnp.asarray(rgb), 0))
    tc = torch.tensor(comp)

    sp, jsp = tsat.make_sat_plan(plan.fs, 720), jsat.make_sat_plan(plan.fs, 720)
    t_fm = tsat.fm_modulate(sp, tc).numpy()
    j_fm = np.asarray(jsat.fm_modulate(jsp, jnp.asarray(comp)))
    g_fm = gt.fm_modulate(sp, comp)
    print(json.dumps({"row": "fm_modulate", "port_vs_golden_db": _parity_db(t_fm, g_fm),
                      "jax_vs_golden_db": _parity_db(j_fm, g_fm),
                      "port_vs_jax_db": _parity_db(t_fm, j_fm)}))
    t_rt = tsat.sat_roundtrip(sp, tc)
    j_rt = np.asarray(jsat.sat_roundtrip(jsp, jnp.asarray(comp)))
    print(json.dumps({
        "row": "sat_roundtrip",
        "port_vs_jax_max_abs": float(np.abs(t_rt.numpy() - j_rt).max()),
        "port_batch_vs_alone_max_abs": float((t_rt[1:] - tsat.sat_roundtrip(sp, tc[1:]))
                                             .abs().max()),
        "jax_batch_vs_alone_max_abs": float(np.abs(
            j_rt[1:] - np.asarray(jsat.sat_roundtrip(jsp, jnp.asarray(comp[1:])))).max())}))

    rfp, jrfp = trf.make_rf_plan(tplan), jrf.make_rf_plan(plan)
    t_rf = trf.rf_modulate(rfp, tc, 3).numpy()
    g_rf = gt.rf_modulate(rfp, comp, 3)
    g32 = g_rf.astype(np.float32)
    t_out = trf.rf_demodulate(rfp, torch.tensor(g32), 3).numpy()
    print(json.dumps({
        "row": "rf",
        "modulate_port_vs_golden_db": _parity_db(t_rf, g_rf),
        "modulate_port_vs_jax_db": _parity_db(
            t_rf, np.asarray(jrf.rf_modulate(jrfp, jnp.asarray(comp), 3))),
        "demodulate_port_vs_golden_db": _parity_db(t_out, gt.rf_demodulate(rfp, g32, 3)),
        "demodulate_port_vs_jax_db": _parity_db(
            t_out, np.asarray(jrf.rf_demodulate(jrfp, jnp.asarray(g32), 3)))}))

    def chain(c):
        return trf.rf_demodulate(rfp, trf.rf_ghost(rfp, trf.rf_modulate(rfp, c, 0), 3.0, 0.3), 0)

    rx = chain(torch.tensor(teq.gcr_record_guarded(tplan))[None])[0][:3]
    pv = rfp.video_zero
    t_taps = teq.design_equalizer(tplan, rx, ntaps=1281, reg=1e-4, pivot=pv).numpy()
    j_taps = np.asarray(jeq.design_equalizer(plan, jnp.asarray(rx.numpy()), ntaps=1281,
                                             reg=1e-4, pivot=pv))
    print(json.dumps({"row": "equalizer",
                      "taps_port_vs_jax_max_abs": float(np.abs(t_taps - j_taps).max())}))


if __name__ == "__main__":
    main()
