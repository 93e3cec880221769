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
  taps, reg 1e-4, pivot ``video_zero``);
* ``sound``: the FM phase integrals, where the port sums the float32
  deviation steps in float64 and the JAX package in float32: parity of
  ``sound_on_rf`` (the fixture of tests/test_golden_sound.py, 2 x 16 lines,
  phi0 1.234), of ``a2_on_rf`` and of the satellite ladder's
  ``fm_modulate(audio=)`` against ``golden/sound.py``, port and JAX; the
  largest phase error of a float32 ``cumsum`` against the float64 sum over
  the 16 x 480-line joined stream of ``chip_smoke.py`` phase 4h's
  soundtrack (22 M RF samples); and NICAM's DQPSK symbol phase over 25
  frames (9100 symbols), the JAX package's float32 sum of the increments
  against the exact count of quarter turns.
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
    sound_rows(plan, tplan, comp)


def sound_rows(plan, tplan, comp) -> None:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from color_modem_tpu.frame import a2 as ja2
    from color_modem_tpu.frame import nicam as jn
    from color_modem_tpu.frame import rf as jrf
    from color_modem_tpu.frame import satellite as jsat
    from color_modem_tpu.golden import sound as gs
    from color_modem_tpu_torch.dsp.nco import running_phase
    from color_modem_tpu_torch.frame import a2 as ta2
    from color_modem_tpu_torch.frame import rf as trf
    from color_modem_tpu_torch.frame import satellite as tsat

    def tones(b, t, freqs):
        tt = np.arange(t, dtype=np.float64) / plan.fs
        return np.stack([0.6 * np.sin(2 * np.pi * f * tt) + 0.2 * np.sin(2 * np.pi * 2.7 * f * tt)
                         for f in freqs[:b]]).astype(np.float32)

    rfp, jrfp = trf.make_rf_plan(tplan), jrf.make_rf_plan(plan)
    row = {"row": "sound"}
    audio = tones(2, 16 * 720, (700.0, 1700.0))
    rf0 = np.zeros((2, 16, rfp.n_rf), np.float32)
    g = gs.sound_on_rf(jrfp, rf0, 3, audio, 1.234)
    t = trf.sound_on_rf(rfp, torch.tensor(rf0), 3, torch.tensor(audio), 1.234).numpy()
    j = np.asarray(jrf.sound_on_rf(jrfp, jnp.asarray(rf0), 3, jnp.asarray(audio), 1.234))
    row.update(sound_on_rf_port_vs_golden_db=_parity_db(t, g),
               sound_on_rf_jax_vs_golden_db=_parity_db(j, g))
    a2p, ja2p = ta2.make_a2_plan(rfp), ja2.make_a2_plan(jrfp)
    audio2 = tones(1, 16 * 720, (1300.0,))
    g = gs.a2_on_rf(ja2p, rf0[:1], 3, audio2, "stereo")
    row.update(
        a2_on_rf_port_vs_golden_db=_parity_db(
            ta2.a2_on_rf(a2p, torch.tensor(rf0[:1]), 3, torch.tensor(audio2)).numpy(), g),
        a2_on_rf_jax_vs_golden_db=_parity_db(
            np.asarray(ja2.a2_on_rf(ja2p, jnp.asarray(rf0[:1]), 3, jnp.asarray(audio2))), g))
    sp, jsp = (m.make_sat_plan(plan.fs, 720, audio_subs=1) for m in (tsat, jsat))
    n_tot = 16 * 720
    sub = np.broadcast_to(0.7 * np.sin(2 * np.pi * 9 * np.arange(n_tot) / n_tot),
                          (2, 1, n_tot)).astype(np.float32)
    g = gs.sat_fm_modulate_audio(jsp, comp, sub)
    row.update(
        ladder_port_vs_golden_db=_parity_db(
            tsat.fm_modulate(sp, torch.tensor(comp), audio=torch.tensor(sub)).numpy(), g),
        ladder_jax_vs_golden_db=_parity_db(
            np.asarray(jsat.fm_modulate(jsp, jnp.asarray(comp), audio=jnp.asarray(sub))), g))
    # the joined 16 x 480-line stream of phase 4h's soundtrack, at the RF rate
    tt = np.arange(16 * 480 * 720) / plan.fs
    track = (0.6 * np.sin(2 * np.pi * 1000 * tt) + 0.3 * np.sin(2 * np.pi * 7000 * tt))
    steps = np.float32(2 * np.pi * rfp.snd_dev / rfp.fs_rf) * np.repeat(
        track.astype(np.float32), rfp.r)
    exact = running_phase(torch.tensor(steps)[None], rfp.n_rf)[0].numpy()
    row["stream_float32_cumsum_max_rad"] = float(np.abs(
        np.cumsum(steps, dtype=np.float32) - exact).max())
    row["stream_jax_cumsum_max_rad"] = float(np.abs(
        np.asarray(jnp.cumsum(jnp.asarray(steps))) - exact).max())
    rng = np.random.default_rng(0)
    dibit = rng.integers(0, 4, 25 * jn.SYMBOLS_PER_FRAME)
    step = np.asarray([jn._DQPSK_PHASE[k] for k in range(4)], np.float32)[dibit]
    quarters = np.cumsum(np.asarray([0, 3, 1, 2])[dibit]) % 4
    drift = np.angle(np.exp(1j * (np.asarray(jnp.cumsum(jnp.asarray(step)), np.float64)
                                  - quarters * np.pi / 2)))
    row["nicam_symbol_phase_jax_max_rad"] = float(np.abs(drift).max())
    print(json.dumps(row))


if __name__ == "__main__":
    main()
