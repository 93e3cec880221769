"""Plans — everything derived from (StandardConfig, line width), as an
``nn.Module`` of float32 buffers.

Port of ``color_modem_tpu/modem/plan.py``: :class:`QamPlan` for the QAM
family (NTSC, PAL and its variants, NIIR) and :class:`FmPlan` for SECAM.
The taps are designed once on the host in float64
(:mod:`color_modem_tpu_torch.dsp.design`), kept as designed in
``plan.host``, and registered as float32 buffers so that
:func:`plan_on` gives a copy of them on the card (``plan.to(device)``
would move the caller's plan in place).  :func:`plan_from_numpy`
carries a JAX ``ModemPlan``'s own arrays across instead, so a test can feed
both packages the same parameters.
"""

from __future__ import annotations

import copy
import weakref

import numpy as np
import torch
from torch import nn

from color_modem_tpu_torch.standards.base import StandardConfig
from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.apply import toeplitz_same, toeplitz_same_held
from color_modem_tpu_torch.kernels.tiles import band_tiles, band_tiles16
from color_modem_tpu_torch.dsp.nco import sample_phase_ramp
from color_modem_tpu_torch.utils.tracing import span

#: the sample rate the default tap counts were tuned at (every standard's
#: 720-sample active line): tap counts scale as fs/REF_FS so each filter
#: keeps its time span across line widths (``color_modem_tpu/modem/plan.py``)
REF_FS = 13.5e6

#: SECAM quadrature-mix LPF cutoff: passes the FM baseband the
#: discriminator tracks (about 0.5 MHz excursion plus sidebands) and rejects
#: the mixing products; 1.4 MHz is the JAX package's swept optimum
SECAM_MIX_LPF = 1.4e6
#: SECAM decode-side blanking margin, samples per side at 13.5 MHz: the
#: decoder rebuilds the blanking neighbourhood (held luma pedestal, and on
#: the left the rest carrier) instead of a hard zero edge
SECAM_MARGIN = 48
#: samples averaged for the blanking luma pedestal (about 8.5 carrier
#: cycles, so the carrier averages out)
SECAM_LUMA_EST = 27
#: half-width of the SECAM chroma takeoff / luma-notch band around bell_f0
SECAM_TAKEOFF_HALFWIDTH = 2.0e6
SECAM_BAND_TRANSITION = 0.4e6
#: SECAM tap counts at REF_FS: the carrier-band filters (anti-cloche, bell
#: takeoff, luma notch), the differentiator, and the emphasis pair (the
#: de-emphasis pole at 85 kHz has a ~1.9 us tail)
SECAM_BELL_NTAPS, SECAM_DIFF_NTAPS, SECAM_EMPH_NTAPS = 193, 31, 257
#: the adaptive combs' energy smoother (``separate/comb.py``): cutoff and a
#: FIXED tap count, not scaled by fs/REF_FS (``color_modem_tpu/modem/plan.py``)
COMB_SEL_CUTOFF, COMB_SEL_NTAPS = 0.5e6, 63

#: the host arrays a QAM plan is built from, all float64 NumPy
HOST_FIELDS = (
    "ramp", "c1_lpf", "c2_lpf", "chroma_bpf", "comb_sel_lpf", "rgb_to_ycc",
    "ycc_to_rgb",
)
#: the FM (SECAM) filters, in the JAX ``ModemPlan``'s field names
FM_TAPS = (
    "comp_lpf", "preemph", "deemph", "anticloche", "bell_takeoff",
    "luma_notch", "mix_lpf", "diff", "demod_lpf",
)
#: the host arrays an FM plan is built from
FM_HOST_FIELDS = FM_TAPS + (
    "fm_margin_carrier", "mix_ramp_ext", "fm_carrier_ramp",
    "rgb_to_ycc", "ycc_to_rgb",
)


def _odd(x: float) -> int:
    v = max(3, int(round(x)))
    return v if v % 2 == 1 else v + 1


def _ramp_rows(ramp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float32 cos/sin of a phase ramp, computed in float64 on the host
    (``color_modem_tpu/kernels/qam.py::_ramp_rows``,
    ``kernels/secam.py``'s ``mixcos``/``mixsin``)."""
    r64 = np.asarray(ramp, np.float64)
    return np.cos(r64).astype(np.float32), np.sin(r64).astype(np.float32)


class _Plan(nn.Module):
    """Fields both families share; ``host`` arrays become float32 buffers."""

    def __init__(self, cfg: StandardConfig, n_samples: int, fs: float,
                 fields: tuple, host: dict):
        super().__init__()
        if set(host) != set(fields):
            raise ValueError(
                f"{type(self).__name__} needs {fields}, got {sorted(host)}"
            )
        self.cfg = cfg
        self.n_samples = int(n_samples)
        self.fs = float(fs)
        self.total_lines = int(cfg.total_lines)
        self.host = {k: np.asarray(v, np.float64) for k, v in host.items()}
        for name, arr in self.host.items():
            self.register_buffer(name, torch.tensor(arr, dtype=torch.float32))

    def _register_mats(self, suffix: str, build, names, n: int) -> None:
        for name in names:
            self.register_buffer(
                name + suffix, torch.tensor(build(self.host[name], n))
            )

    @property
    def chroma(self):
        return self.cfg.chroma


class QamPlan(_Plan):
    """Host constants of one (QAM standard, line width) pair.

    Buffers (float32): ``ramp``, ``ramp_cos``, ``ramp_sin`` (N,);
    ``c1_lpf``, ``c2_lpf``, ``chroma_bpf`` (T,); ``comb_sel_lpf`` (63,), the
    adaptive combs' energy smoother; ``rgb_to_ycc``, ``ycc_to_rgb`` (3, 3);
    and the ``(N, N)`` Toeplitz matrices ``c1_lpf_mat``, ``c2_lpf_mat``,
    ``chroma_bpf_mat``, ``comb_sel_lpf_mat`` of the plain FIR; the
    ``(S, 32, 4)`` TF32 hi/lo band tiles ``c1_lpf_tiles``, ``c2_lpf_tiles``,
    ``chroma_bpf_tiles`` of the kernels' tensor-core FIR
    (:func:`~color_modem_tpu_torch.kernels.tiles.band_tiles`, built from the
    float64 taps).
    Python scalars: ``theta``, ``cpl_num``, ``cpl_den``, ``total_lines``,
    ``n_samples``, ``fs``.  ``host`` keeps the float64 arrays as designed.
    """

    def __init__(self, cfg: StandardConfig, n_samples: int, fs: float, *,
                 theta: float, **host: np.ndarray):
        if cfg.is_fm:
            raise TypeError(f"QamPlan takes a QAM standard, got {cfg.name}")
        super().__init__(cfg, n_samples, fs, HOST_FIELDS, host)
        self.theta = float(theta)
        self.cpl_num = int(cfg.cpl_num)
        self.cpl_den = int(cfg.cpl_den)
        rc, rs = _ramp_rows(self.host["ramp"])
        self.register_buffer("ramp_cos", torch.tensor(rc))
        self.register_buffer("ramp_sin", torch.tensor(rs))
        self._register_mats("_mat", toeplitz_same,
                            ("c1_lpf", "c2_lpf", "chroma_bpf", "comb_sel_lpf"),
                            self.n_samples)
        for name in ("c1_lpf", "c2_lpf", "chroma_bpf"):
            self.register_buffer(name + "_tiles",
                                 torch.tensor(band_tiles(self.host[name])))


class FmPlan(_Plan):
    """Host constants of one (SECAM, line width) pair.

    Buffers (float32): the nine filters of :data:`FM_TAPS` (T,);
    ``fm_carrier_ramp`` (N,), the midpoint-rule carrier phase base;
    ``fm_margin_carrier`` (2, M), the left blanking carrier per parity
    ``[B, R]``; ``mix_ramp_ext`` (N+2M,) and its float64-built
    ``mix_cos``/``mix_sin`` rows; ``rgb_to_ycc``, ``ycc_to_rgb``.  The
    plain FIR's Toeplitz matrices: held at N, ``comp_lpf_held``,
    ``preemph_held``; zero-edged at N, ``anticloche_mat``; zero-edged at
    N+2M, ``bell_takeoff_mat``, ``luma_notch_mat``, ``mix_lpf_mat``,
    ``diff_mat``, ``deemph_mat``, ``demod_lpf_mat``.  The kernels'
    tensor-core FIR: the ``(8S + 24, 2)`` TF32 hi/lo tables of the 16x8
    band tiles, ``<filter>_tiles``, of each of the nine filters
    (:func:`~color_modem_tpu_torch.kernels.tiles.band_tiles16`, built from
    the float64 taps).  Python scalars:
    ``f_center``, ``fm_margin`` (M), ``fm_luma_est``, ``total_lines``,
    ``n_samples``, ``fs``.
    """

    def __init__(self, cfg: StandardConfig, n_samples: int, fs: float, *,
                 f_center: float, fm_margin: int, fm_luma_est: int,
                 **host: np.ndarray):
        if not cfg.is_fm:
            raise TypeError(f"FmPlan takes an FM standard, got {cfg.name}")
        super().__init__(cfg, n_samples, fs, FM_HOST_FIELDS, host)
        self.f_center = float(f_center)
        self.fm_margin = int(fm_margin)
        self.fm_luma_est = int(fm_luma_est)
        n_ext = self.n_samples + 2 * self.fm_margin
        mc, ms = _ramp_rows(self.host["mix_ramp_ext"])
        self.register_buffer("mix_cos", torch.tensor(mc))
        self.register_buffer("mix_sin", torch.tensor(ms))
        self._register_mats("_held", toeplitz_same_held, ("comp_lpf", "preemph"),
                            self.n_samples)
        self._register_mats("_mat", toeplitz_same, ("anticloche",), self.n_samples)
        self._register_mats(
            "_mat", toeplitz_same,
            ("bell_takeoff", "luma_notch", "mix_lpf", "diff", "deemph", "demod_lpf"),
            n_ext,
        )
        for name in FM_TAPS:
            self.register_buffer(name + "_tiles",
                                 torch.tensor(band_tiles16(self.host[name])))


def make_plan(cfg: StandardConfig, n_samples: int, *,
              ntaps: int = 129) -> QamPlan | FmPlan:
    """Build the plan for ``cfg`` at ``n_samples`` per active line: a
    :class:`QamPlan` or, for SECAM, an :class:`FmPlan`."""
    fs = cfg.sample_rate(n_samples)
    k = fs / REF_FS  # tap-count scale (REF_FS comment)
    ntaps = _odd(ntaps * k)
    common = dict(rgb_to_ycc=cfg.rgb_to_ycc_np(), ycc_to_rgb=cfg.ycc_to_rgb_np())
    ch = cfg.chroma
    if not cfg.is_fm:
        if fs < 2.5 * ch.fsc:
            raise ValueError(
                f"{cfg.name}: fs={fs/1e6:.2f} MHz < 2.5*fsc; use a wider line"
            )
        return QamPlan(
            cfg, n_samples, fs,
            theta=float(np.deg2rad(ch.phase_offset_deg)),
            ramp=sample_phase_ramp(ch.fsc, fs, n_samples),
            c1_lpf=design.lowpass_taps(fs, ch.c1_bandwidth, ntaps),
            c2_lpf=design.lowpass_taps(fs, ch.c2_bandwidth, ntaps),
            chroma_bpf=design.bandpass_taps(
                fs, ch.fsc - ch.chroma_band, ch.fsc + ch.chroma_band, ntaps
            ),
            comb_sel_lpf=design.lowpass_taps(fs, COMB_SEL_CUTOFF, COMB_SEL_NTAPS),
            **common,
        )
    bell_ntaps = _odd(SECAM_BELL_NTAPS * k)
    diff_ntaps = _odd(SECAM_DIFF_NTAPS * k)
    emph_ntaps = _odd(SECAM_EMPH_NTAPS * k)
    margin = int(round(SECAM_MARGIN * k))
    luma_est = max(3, int(round(SECAM_LUMA_EST * k)))
    f_center = 0.5 * (ch.f0r + ch.f0b)
    band_lo = ch.bell_f0 - SECAM_TAKEOFF_HALFWIDTH
    band_hi = ch.bell_f0 + SECAM_TAKEOFF_HALFWIDTH
    if fs < 2.0 * (band_hi + SECAM_BAND_TRANSITION):
        raise ValueError(
            f"secam: fs={fs/1e6:.2f} MHz too low for the chroma band; "
            "use a wider line (e.g. 720+ samples)"
        )
    bell = (ch.bell_f0, ch.bell_m0, ch.bell_k_num, ch.bell_k_den)

    def band_mask(f):
        return design.raised_cosine_bandpass_response(
            f, band_lo, band_hi, SECAM_BAND_TRANSITION
        )

    def anticloche_resp(f):
        return design.secam_anticloche_response(f, *bell) * band_mask(f)

    def takeoff_resp(f):
        return design.secam_cloche_response(f, *bell) * band_mask(f)

    return FmPlan(
        cfg, n_samples, fs,
        f_center=f_center,
        fm_margin=margin,
        fm_luma_est=luma_est,
        comp_lpf=design.lowpass_taps(fs, ch.component_bandwidth, ntaps),
        preemph=design.freq_sampled_taps(
            fs, lambda f: design.secam_preemph_response(f, ch.preemph_f1), emph_ntaps
        ),
        deemph=design.freq_sampled_taps(
            fs, lambda f: design.secam_deemph_response(f, ch.preemph_f1), emph_ntaps
        ),
        anticloche=design.freq_sampled_taps(fs, anticloche_resp, bell_ntaps),
        bell_takeoff=design.freq_sampled_taps(fs, takeoff_resp, bell_ntaps),
        luma_notch=design.freq_sampled_taps(fs, band_mask, bell_ntaps),
        mix_lpf=design.lowpass_taps(fs, SECAM_MIX_LPF, ntaps),
        diff=design.differentiator_taps(fs, diff_ntaps),
        demod_lpf=design.lowpass_taps(fs, ch.demod_lpf, ntaps),
        # left blanking carrier per parity (B even / R odd line): the
        # anti-cloche floor M0 at the rest frequency, phase per the
        # sample-0 convention
        fm_margin_carrier=np.stack([
            ch.bell_m0 * np.cos(
                2.0 * np.pi * f0 / fs
                * (np.arange(-margin, 0, dtype=np.float64) + 0.5)
            )
            for f0 in (ch.f0b, ch.f0r)
        ]),
        mix_ramp_ext=2.0 * np.pi * np.mod(
            f_center / fs
            * np.arange(-margin, n_samples + margin, dtype=np.float64),
            1.0,
        ),
        # 2*pi*frac(fc*(n+0.5)/fs): the midpoint-rule FM integral's base, so
        # the float32 scan only sees the small deviation term
        fm_carrier_ramp=2.0
        * np.pi
        * np.mod(f_center / fs * (np.arange(n_samples) + 0.5), 1.0),
        **common,
    )


#: plan -> {device: its copy there}, kept while the plan lives
_COPIES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _placed(device: torch.device) -> tuple[str, int | None]:
    """(type, index) of a device, a bare "cuda" read as the current card."""
    if device.type == "cuda" and device.index is None:
        return "cuda", torch.cuda.current_device()
    return device.type, device.index


def plan_on(plan: QamPlan | FmPlan, device: torch.device | str) -> QamPlan | FmPlan:
    """``plan`` itself when its buffers lie on ``device``, else a copy of it
    whose buffers lie there: made once per (plan, device) and kept while the
    plan lives, so a factory uploads nothing per call.  The caller's plan is
    never moved: any number of pipelines on any devices share it, as they
    share a JAX ``ModemPlan``."""
    device = torch.device(device)
    if _placed(plan.rgb_to_ycc.device) == _placed(device):
        return plan
    copies = _COPIES.setdefault(plan, {})
    key = str(device)
    if key not in copies:
        with span("cm.build.plan_copy"):
            # a shallow copy with buffers of its own: the host arrays and the
            # config are shared and never written
            new = copy.copy(plan)
            new._buffers = {k: v.to(device) for k, v in plan._buffers.items()}
            copies[key] = new
    return copies[key]


def plan_from_numpy(p) -> QamPlan | FmPlan:
    """A plan from any object with the ``ModemPlan`` NumPy attributes, such
    as a JAX ``ModemPlan``: ``cfg``, ``n_samples``, ``fs``, and ``theta`` and
    :data:`HOST_FIELDS` (QAM) or ``f_center``, ``fm_margin``,
    ``fm_luma_est`` and :data:`FM_HOST_FIELDS` (FM)."""
    if p.cfg.is_fm:
        return FmPlan(
            p.cfg, p.n_samples, p.fs,
            f_center=p.f_center, fm_margin=p.fm_margin, fm_luma_est=p.fm_luma_est,
            **{k: getattr(p, k) for k in FM_HOST_FIELDS},
        )
    return QamPlan(
        p.cfg, p.n_samples, p.fs, theta=p.theta,
        **{k: getattr(p, k) for k in HOST_FIELDS},
    )
