"""The full-stack 625-line broadcast through the PyTorch port's library calls.

Interlaced, rastered PAL on the 1440-sample (27 MHz) grid; caption cells,
a teletext page, WSS and VITC on the first field's top rows (in that
order, each in the active part of its rastered row); cut-and-rotate
scrambling of the active picture (sync and burst in the clear); the RF/VSB
hop with FM mono sound and either NICAM-728 or A2 two-carrier stereo.  The
receiver demodulates, keeps the pirate's view, descrambles with the key,
decodes the picture and reads every service back.  It is the composition
of ``color_modem_tpu/cli.py``'s ``roundtrip --interlaced --raster
--teletext --wss --vitc --caption --scramble cutrotate --rf --rf-audio``
with ``--rf-nicam`` or ``--rf-a2 stereo``, on the same stimuli, and its
report carries the same keys.  Run from the repository root:

    python3 scripts/torch_fullstack.py --sound nicam --lines 64 --device cpu

``tests/test_torch_fullstack.py`` holds it against the JAX CLI on the CPU
and ``chip_smoke.py`` phase 4i runs it on the card at 576 lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from color_modem_tpu_torch import PAL  # noqa: E402
from color_modem_tpu_torch.frame import a2 as a2_mod  # noqa: E402
from color_modem_tpu_torch.frame import nicam as nicam_mod  # noqa: E402
from color_modem_tpu_torch.frame import teletext, vitc, wss  # noqa: E402
from color_modem_tpu_torch.frame.interlace import (  # noqa: E402
    field_line_index,
    make_interlaced_pipeline,
)
from color_modem_tpu_torch.frame.pipeline import resolve_device  # noqa: E402
from color_modem_tpu_torch.frame.raster import make_raster  # noqa: E402
from color_modem_tpu_torch.frame.rf import (  # noqa: E402
    make_rf_plan,
    rf_demodulate,
    rf_demodulate_sound,
    rf_modulate,
)
from color_modem_tpu_torch.frame.scramble import descramble, scramble  # noqa: E402
from color_modem_tpu_torch.frame.vbi import (  # noqa: E402
    cc_pack,
    cc_spec,
    cc_unpack,
    decode_data_line,
    encode_data_line,
)
from color_modem_tpu_torch.modem.plan import make_plan, plan_on  # noqa: E402
from color_modem_tpu_torch.utils.metrics import psnr  # noqa: E402
from color_modem_tpu_torch.utils.testimages import smooth_scene  # noqa: E402
from color_modem_tpu_torch.utils.upload import upload  # noqa: E402

CAPTION = "FULL STACK"
TELETEXT = ("HELLO WORLD", "ROW TWO")
WSS = "16:9 full (anamorphic)"
VITC = (1, 2, 3, 4)
SCRAMBLE_KEY = 0x5EC4E7
WIDTH = 1440  # the 27 MHz grid teletext needs


def _snr_db(want: np.ndarray, got: np.ndarray) -> float:
    err = got - want
    return float(10.0 * np.log10(max(float(np.mean(want ** 2)), 1e-20)
                                 / max(float(np.mean(err ** 2)), 1e-20)))


@torch.inference_mode()
def transmit(plan, rgb: torch.Tensor, *, nicam: bool, a2: bool):
    """The transmitter of frame 0: (RF block, the sent values the receiver
    is held to, the plans the receiver needs).  ``rgb`` (3, L, N) on the
    plan's device."""
    if nicam and a2:
        raise ValueError("A2 and NICAM cannot share a channel: A2's second carrier "
                         "(FM sound + 15.5 fh = +242 kHz) sits inside NICAM's lower "
                         "sideband (+245..755 kHz); pick one")
    dev = rgb.device
    lines = rgb.shape[-2]
    enc, dec, _ = make_interlaced_pipeline(plan, "comb3", "kernel", dev, raster=True)
    comp = enc(rgb[None], 0)                          # (2, L/2, n_total)
    rp = make_raster(plan)
    off = rp.n_blank
    # captions, teletext, WSS, VITC on field 0's top rows
    cap_text = CAPTION + (" " if len(CAPTION) % 2 else "")
    cells = [cap_text[i : i + 2] for i in range(0, len(cap_text), 2)]
    n_cap = len(cells)
    cap = cc_spec(plan)
    comp[0, :n_cap, off:] = encode_data_line(
        plan, cap, upload(np.stack([cc_pack(c).numpy() for c in cells]), dev))
    page = teletext.encode_page(plan, 1, 0x00, list(TELETEXT),
                                header=f"P100 {plan.cfg.name.upper()}", device=dev)
    n_ttx = page.shape[0]
    comp[0, n_cap : n_cap + n_ttx, off:] = page
    wss_row, vitc_row = n_cap + n_ttx, n_cap + n_ttx + 1
    comp[0, wss_row, off:] = wss.encode_wss(plan, upload(wss.wss_word(WSS).numpy(), dev))
    comp[0, vitc_row, off:] = vitc.encode_vitc_line(plan, upload(vitc.vitc_pack(*VITC), dev))
    g_scr = field_line_index(plan, 0, 1, lines // 2, dev)
    comp = scramble(plan, comp, g_scr, "cutrotate", SCRAMBLE_KEY, active_start=off)
    # the RF hop with its sound
    rfp = make_rf_plan(plan, row_samples=rp.n_total)
    n_rf = comp.shape[-2] * comp.shape[-1]
    t = np.arange(n_rf) / plan.fs
    sent = {"rows": (n_cap, n_ttx, wss_row, vitc_row), "cap_text": cap_text, "off": off,
            "g_scr": g_scr}
    if a2:
        a2_l = (0.6 * np.sin(2 * np.pi * 800 * t) + 0.2 * np.sin(2 * np.pi * 5000 * t)
                ).astype(np.float32)
        a2_r = (0.5 * np.sin(2 * np.pi * 2300 * t)).astype(np.float32)
        a2_l, a2_r = (np.broadcast_to(a, (comp.shape[0], n_rf)) for a in (a2_l, a2_r))
        audio = 0.5 * (a2_l + a2_r)
        sent.update(a2_l=a2_l, a2_r=a2_r)
    else:
        audio = np.broadcast_to((0.6 * np.sin(2 * np.pi * 1000 * t)
                                 + 0.3 * np.sin(2 * np.pi * 7000 * t)).astype(np.float32),
                                (comp.shape[0], n_rf))
    sent["audio"] = audio
    rf = rf_modulate(rfp, comp, 0, upload(audio, dev))
    plans = {"rfp": rfp, "dec": dec}
    if a2:
        plans["a2p"] = a2_mod.make_a2_plan(rfp)
        rf = a2_mod.a2_on_rf(plans["a2p"], rf, 0, upload(sent["a2_r"], dev), "stereo")
    if nicam:
        n_frames = nicam_mod.nicam_capacity(rfp, rf.shape)
        if n_frames < 1:
            raise ValueError("the RF block is shorter than one 728-bit NICAM frame")
        ta = np.arange(nicam_mod.BLOCK * n_frames) / 32000.0
        sent["nic_l"] = (0.7 * np.sin(2 * np.pi * 1000 * ta)).astype(np.float32)
        sent["nic_r"] = (0.5 * np.sin(2 * np.pi * 3000 * ta)).astype(np.float32)
        sent["nic_frames"] = n_frames
        rf = nicam_mod.nicam_on_rf(rfp, rf, upload(sent["nic_l"], dev),
                                   upload(sent["nic_r"], dev))
    return rf, sent, plans


@torch.inference_mode()
def receive(plan, rf: torch.Tensor, sent: dict, plans: dict, *, nicam: bool, a2: bool):
    """The receiver of frame 0: (decoded frame (3, L, N), the pirate's
    frame, the service and sound report)."""
    rfp, dec, off = plans["rfp"], plans["dec"], sent["off"]
    comp = rf_demodulate(rfp, rf, 0)
    pirate = dec(comp, 0)[0]
    comp = descramble(plan, comp, sent["g_scr"], "cutrotate", SCRAMBLE_KEY, active_start=off)
    out = dec(comp, 0)[0]
    n_cap, n_ttx, wss_row, vitc_row = sent["rows"]
    rep = {}
    bits, margin = decode_data_line(plan, cc_spec(plan), comp[0, :n_cap, off:])
    cells = [cc_unpack(b) for b in bits.cpu()]
    received = "".join(c for c, _ in cells)
    rep["caption"] = {"received": received, "exact": received == sent["cap_text"],
                      "parity_ok": all(ok for _, ok in cells),
                      "worst_margin": float(margin.min())}
    pkts = teletext.decode_packets(plan, comp[0, n_cap : n_cap + n_ttx, off:])
    rows = [p.text.rstrip() for p in pkts[1:]]
    rep["teletext"] = {"page": pkts[0].page, "header": pkts[0].text.rstrip(), "rows": rows,
                       "exact": rows == [t.rstrip() for t in TELETEXT],
                       "address_ok": all(p.address_ok for p in pkts),
                       "parity_ok": all(bool(p.parity_ok.all()) for p in pkts),
                       "worst_margin": min(p.margin for p in pkts)}
    got, _ = wss.decode_wss(plan, comp[0, wss_row, off:])
    w = wss.parse_wss(got)
    rep["wss"] = {"received": w["aspect"], "exact": w["aspect"] == WSS and w["aspect_ok"]}
    got, score = vitc.decode_vitc_line(plan, comp[0, vitc_row, off:])
    v = vitc.vitc_unpack(got)
    tc = (v["hours"], v["minutes"], v["seconds"], v["frames"])
    rep["vitc"] = {"received": "%02d:%02d:%02d:%02d" % tc, "exact": tc == VITC and v["crc_ok"],
                   "crc_ok": v["crc_ok"], "sync_score": int(score)}
    sound = {}
    if a2:
        gl, gr, info = a2_mod.a2_decode(plans["a2p"], rf, 0, group=2)
        gl, gr = gl.cpu().numpy(), gr.cpu().numpy()
        crop = min(8192, gl.shape[-1] // 4)
        cut = slice(crop, -crop)
        sound["a2"] = {"mode_detected": info["mode"][0],
                       "left_snr_db": _snr_db(sent["a2_l"][:, cut], gl[:, cut]),
                       "right_snr_db": _snr_db(sent["a2_r"][:, cut], gr[:, cut])}
    else:
        aud = rf_demodulate_sound(rfp, rf, 0).cpu().numpy()
        crop = min(8192, aud.shape[-1] // 4)
        sound["audio_snr_db"] = _snr_db(sent["audio"][:, crop:-crop], aud[:, crop:-crop])
    if nicam:
        n_l, n_r, n_rep, _ = nicam_mod.nicam_from_rf(rfp, rf, sent["nic_frames"])
        sound["nicam"] = {"frames": sent["nic_frames"],
                          "left_snr_db": _snr_db(sent["nic_l"], n_l.cpu().numpy()),
                          "right_snr_db": _snr_db(sent["nic_r"], n_r.cpu().numpy()),
                          "parity_errors": int(n_rep["parity_errors"].sum()),
                          "faw_ok": bool(n_rep["faw_ok"].all())}
    rep["rf"] = sound
    return out, pirate, rep


@torch.inference_mode()
def full_stack(*, nicam: bool = False, a2: bool = False, lines: int = 64,
               device: torch.device | str = "cuda") -> dict:
    """Transmit and receive ``smooth_scene(lines, WIDTH)`` through the whole
    stack; the report of the JAX CLI's keys: ``caption``, ``teletext``,
    ``wss``, ``vitc`` (each with ``exact``), ``psnr_db`` over the picture
    rows (the data rows of field 0 weave to the frame's first
    ``2 * service rows``), ``scramble.pirate_psnr_db`` over the same rows,
    and ``rf`` (the sound)."""
    dev = resolve_device(device)
    plan = plan_on(make_plan(PAL(), WIDTH), dev)
    rgb = upload(smooth_scene(lines, WIDTH).astype(np.float32), dev)
    rf, sent, plans = transmit(plan, rgb, nicam=nicam, a2=a2)
    out, pirate, rep = receive(plan, rf, sent, plans, nicam=nicam, a2=a2)
    data_rows = 2 * (sent["rows"][3] + 1)
    rep["psnr_db"] = psnr(out[:, data_rows:], rgb[:, data_rows:])
    rep["scramble"] = {"mode": "cutrotate", "key": SCRAMBLE_KEY,
                       "pirate_psnr_db": psnr(pirate[:, data_rows:], rgb[:, data_rows:])}
    rep["lines"] = lines
    return rep


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sound", choices=("nicam", "a2"), default="nicam")
    ap.add_argument("--lines", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(full_stack(nicam=args.sound == "nicam", a2=args.sound == "a2",
                                lines=args.lines, device=args.device)))


if __name__ == "__main__":
    main()
