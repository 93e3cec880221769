"""The arithmetic of the tensor-core SECAM kernels (``csrc/secam_encode.cu``,
``csrc/secam_decode.cu``) on the CPU.

The kernels cannot run here, so these tests hold a model of them, written
stage by stage as the CUDA code runs: 8 lines per tile on the columns of
``mma.m16n8k8`` and 16 outputs on its rows, the 16x8 Toeplitz A tiles read
from the host-built table of the reversed taps
(``kernels/tiles.py::band_tiles16``) as the kernels read them, the signal
read as B out of shared-memory planes whose column 0 sits at each stage's
own origin, the three TF32 passes with B split by bits as the kernels split
it, the held
staging and held halo of the encoder, its per-row D'R/D'B selection, its
warp-per-line phase scan, the decoder's spans with their recomputed halos,
and every per-row constant (parity, rest frequency, deviation, the margin
carrier, the blanking means).  The model is held against
``encode_lines_plain`` (2e-4) and ``demodulate_lines_plain`` (5e-4 on the
decoded RGB and on the luma) at 720 and 1440 samples, on the plans' own
asymmetric taps; the 16x8 tiles against ``np.convolve`` on random
asymmetric taps; and the tiles carried by ``plan_from_numpy``.
"""

import numpy as np
import pytest
import torch

from color_modem_tpu_torch import SECAM
from color_modem_tpu_torch.dsp.colorimetry import apply_mat3, clamp01
from color_modem_tpu_torch.frame.pipeline import frame_line_index
from color_modem_tpu_torch.kernels import secam as sk
from color_modem_tpu_torch.kernels.tiles import BAND_TILE, band_steps16, band_tiles16
from color_modem_tpu_torch.modem import secam
from color_modem_tpu_torch.modem.plan import FM_TAPS, make_plan, plan_from_numpy
from color_modem_tpu_torch.utils.testimages import smooth_scene
from torch_threads import one_torch_thread  # noqa: F401

ENC_ATOL, DEC_ATOL = 2e-4, 5e-4
#: the card test's bound on the FIR alone (tests/test_torch_kernels_cuda.py)
FIR_ATOL = 2e-6
#: lines per tile (the N of mma.m16n8k8), outputs per tile (its M)
ROWS, OUT = 8, 2 * BAND_TILE
#: shared memory a block may have (bf::kSmemMax)
SMEM_MAX = 227 * 1024


def band_tile16_matrices(taps) -> np.ndarray:
    """(S, 16, 8) float64 tiles ``A_s[r, u] = tr[8s + u - r]`` (0 outside
    ``[0, T)``), ``tr`` the taps reversed: ``out[16t + r] = sum_s sum_u
    A_s[r, u] x~[8(2t + s) + u]`` with ``x~[i] = x[i - (T - 1) / 2]``."""
    taps = np.asarray(taps, np.float64)
    t = len(taps)
    m = (BAND_TILE * np.arange(band_steps16(t))[:, None, None]
         + np.arange(BAND_TILE)[None, None, :] - np.arange(OUT)[None, :, None])
    inside = (m >= 0) & (m < t)
    return np.where(inside, taps[::-1][np.clip(m, 0, t - 1)], 0.0)


def _np_same(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    h = (len(taps) - 1) // 2
    n = x.shape[-1]
    return np.stack([np.convolve(np.pad(r, h), taps, "same")[h : h + n] for r in x])


def _trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 part of a float32 that the tensor core reads."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _tiles_as_mats(table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(8S + 24, 2) table -> (S, 16, 8) float64 hi and lo tiles A_s[r, u],
    read as the kernel reads them: lane (g, q) of step s takes a0..a3 from
    rows d + 16, d + 8, d + 20, d + 12 of the table, d = 8s + q - g."""
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    t = table.numpy()
    steps = (t.shape[0] - 24) // BAND_TILE
    mats = []
    for part in (0, 1):
        m = np.zeros((steps, OUT, BAND_TILE))
        for s in range(steps):
            d = BAND_TILE * s + q - g
            for (r, c), row in zip(((g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)),
                                   (d + 16, d + 8, d + 20, d + 12)):
                m[s, r, c] = t[row, part]
        mats.append(torch.tensor(m))
    return mats[0], mats[1]


def fir16(plane: torch.Tensor, tiles: torch.Tensor, nt: int) -> torch.Tensor:
    """The kernels' FIR over a shared-memory plane, emulated: ``out[:, 16t +
    r] = sum_s sum_u A_s[r, u] plane[:, 8(2t + s) + u]`` for ``t < nt``, B
    split as the kernel splits it (hi = b with its low 13 bits cleared, lo =
    b - hi read as TF32), three passes, each step's products exact
    (float64) and the accumulator float32.  Fails if a read leaves the
    plane."""
    steps = (tiles.shape[0] - 24) // BAND_TILE
    chunks = 2 * nt + steps - 2
    assert BAND_TILE * chunks <= plane.shape[1], (chunks, plane.shape)
    x = plane[:, : BAND_TILE * chunks].reshape(plane.shape[0], chunks, BAND_TILE)
    b_hi = _trunc_tf32(x)
    b_lo = _trunc_tf32(x - b_hi)
    b_hi, b_lo = b_hi.double(), b_lo.double()
    a_hi, a_lo = _tiles_as_mats(tiles)
    acc = torch.zeros(plane.shape[0], nt, OUT, dtype=torch.float32)
    for s in range(steps):
        xs_hi, xs_lo = b_hi[:, s : s + 2 * nt - 1 : 2], b_lo[:, s : s + 2 * nt - 1 : 2]
        step = xs_hi @ a_lo[s].T + xs_lo @ a_hi[s].T + xs_hi @ a_hi[s].T
        acc = (acc.double() + step).float()
    return acc.reshape(plane.shape[0], OUT * nt)


def _half(taps: torch.Tensor) -> int:
    return (taps.numel() - 1) // 2


def _tiles(length: int, kw: int) -> int:
    """Output tiles a stage's group loop runs over ``length`` outputs: whole
    groups of ``kw`` tiles (the CUDA stage's kW), the last one padded."""
    nt = -(-length // OUT)
    return -(-nt // kw) * kw


def _width(length: int, ntaps: int, kw: int) -> int:
    """Columns a stage's FIR reads from its input plane."""
    return BAND_TILE * (2 * _tiles(length, kw) + band_steps16(ntaps) - 2)


def _pitch(width: int) -> int:
    """Floats per plane row: ``bf::pitch_of``, pitch % 32 == 4."""
    return width + (36 - width % 32) % 32


# --- the encoder ------------------------------------------------------------

#: output tiles per warp group of the encoder's three FIRs (secam_encode.cu)
ENC_KW = 4

def encode_geometry(plan) -> tuple[int, int]:
    """(pitch, shared-memory bytes) of the encoder: two planes of 8 rows and
    the carrier ramp."""
    n = plan.n_samples
    widths = [_width(n, getattr(plan, f).numel(), ENC_KW)
              for f in ("comp_lpf", "preemph", "anticloche")]
    pitch = _pitch(max(max(widths), n))
    return pitch, (2 * ROWS * pitch + -(-n // 4) * 4) * 4


def _warp_scan(df: torch.Tensor) -> torch.Tensor:
    """The encoder's phase scan, one warp per line: each lane sums a
    contiguous chunk of ceil(N / 32) increments, the lane sums are scanned
    by shuffles (Hillis-Steele), and each lane walks its chunk again from
    its exclusive prefix: ``run += v; phase = run - v/2``."""
    rows, n = df.shape
    chunk = -(-n // 32)
    d = torch.nn.functional.pad(df, (0, 32 * chunk - n)).reshape(rows, 32, chunk)
    s = torch.zeros(rows, 32, dtype=torch.float32)
    for k in range(chunk):
        s = s + d[..., k]
    incl = s.clone()
    for o in (1, 2, 4, 8, 16):
        shifted = torch.zeros_like(incl)
        shifted[:, o:] = incl[:, :-o]
        incl = incl + shifted
    run = incl - s
    out = torch.empty_like(d)
    for k in range(chunk):
        v = d[..., k]
        run = run + v
        out[..., k] = run - 0.5 * v
    return out.reshape(rows, 32 * chunk)[:, :n]


def model_encode(plan, ycc: torch.Tensor, isr: torch.Tensor) -> torch.Tensor:
    """secam_encode.cu's arithmetic: (G, 3, L, N) + (G*L,) -> (G, L, N)."""
    g, _, l, n = ycc.shape
    rows = g * l
    pitch, _ = encode_geometry(plan)
    h_lpf, h_pre, h_anti = (_half(getattr(plan, f)) for f in
                            ("comp_lpf", "preemph", "anticloche"))
    nt = _tiles(n, ENC_KW)
    r_line = (isr != 0).reshape(rows, 1)
    d = torch.where(r_line, ycc[:, 1].reshape(rows, n), ycc[:, 2].reshape(rows, n))
    # plane 0: d with a held halo
    cols = torch.arange(pitch)
    p0 = d[:, torch.clamp(cols - h_lpf, 0, n - 1)]
    dl = fir16(p0, plan.comp_lpf_tiles, nt)[:, :n]
    # plane 1: dl, then its held halo from its own edge samples
    p1 = torch.zeros(rows, pitch)
    p1[:, h_pre : h_pre + n] = dl
    p1[:, :h_pre] = dl[:, :1]
    p1[:, h_pre + n :] = dl[:, n - 1 : n]
    dpre = fir16(p1, plan.preemph_tiles, nt)[:, :n]
    f0r_c, f0b_c, devr_c, devb_c = sk._encode_consts(plan)
    f0c = torch.where(r_line, f0r_c, f0b_c).float()
    devc = torch.where(r_line, devr_c, devb_c).float()
    df = f0c + devc * dpre
    carrier = torch.cos(plan.fm_carrier_ramp + _warp_scan(df))
    # plane 1 again: the carrier with a zero halo
    p1 = torch.zeros(rows, pitch)
    p1[:, h_anti : h_anti + n] = carrier
    out = ycc[:, 0].reshape(rows, n) + fir16(p1, plan.anticloche_tiles, nt)[:, :n]
    return out.reshape(g, l, n)


# --- the decoder ------------------------------------------------------------

#: output tiles per warp group of the decoder's stages: bell/notch, mix (i
#: and q), diff (di and dq), deemph, demod_lpf (secam_decode.cu)
DEC_KW = {"band": 4, "mix": 2, "diff": 2, "de": 4, "dm": 4}
_DEC_TAPS = {"band": "bell_takeoff", "mix": "mix_lpf", "diff": "diff",
             "de": "deemph", "dm": "demod_lpf"}


def decode_ranges(plan, p0: int, span: int) -> dict:
    """Output ranges [lo, hi) on the extended line of each stage for the
    span of cropped samples [p0, p0 + span): each stage computes what the
    next one reads, clipped to the line (zero outside it)."""
    n, m = plan.n_samples, plan.fm_margin
    n_ext = n + 2 * m
    h = {k: _half(getattr(plan, f)) for k, f in _DEC_TAPS.items()}
    r = {"dm": (m + p0, m + min(p0 + span, n))}
    for k, nxt in (("de", "dm"), ("diff", "de"), ("mix", "diff"), ("band", "mix")):
        lo, hi = r[nxt]
        r[k] = (max(lo - h[nxt], 0), min(hi + h[nxt], n_ext))
    return r


def decode_geometry(plan, span: int) -> tuple[int, int]:
    """(pitch, shared-memory bytes) of the decoder at ``span``: three planes
    of 8 rows, as wide as the widest stage of any span needs and as the
    composite row the third plane holds first."""
    n = plan.n_samples
    width = -(-n // BAND_TILE) * BAND_TILE
    for p0 in range(0, n, span):
        r = decode_ranges(plan, p0, span)
        for k, f in _DEC_TAPS.items():
            width = max(width, _width(r[k][1] - r[k][0], getattr(plan, f).numel(),
                                      DEC_KW[k]))
    pitch = _pitch(width)
    return pitch, 3 * ROWS * pitch * 4


def _pitch8(cols: int) -> int:
    """``ap::pitch8``: the least multiple of 8 plus 4 that holds ``cols``."""
    return -(-cols // 8) * 8 + 4


def decode_pipe_layout(plan) -> dict:
    """The pipelined decoder's shared memory (``secam_decode.cu::pipe_layout``):
    six planes of 8 rows, each as wide as its reader reads and its writer
    writes (ext, takeoff, i, q, v, v (*) deemph), the luma staging rows, the
    six tap tables and the mix rows; pitches and offsets in floats."""
    n, m = plan.n_samples, plan.fm_margin
    r = decode_ranges(plan, 0, n)
    h = {k: _half(getattr(plan, f)) for k, f in _DEC_TAPS.items()}
    order = ("band", "mix", "diff", "de", "dm")
    org = {k: r[k][0] - h[k] for k in order}
    w_in = {k: _width(r[k][1] - r[k][0], getattr(plan, f).numel(), DEC_KW[k])
            for k, f in _DEC_TAPS.items()}
    # plane k holds the output of the stage before k, read by stage k
    pitch = {"band": _pitch8(w_in["band"])}
    for prev, k in zip(order, order[1:]):
        pitch[k] = _pitch8(max(w_in[k], r[prev][1] - org[k]))
    ps = -(-n // 4) * 4
    planes = [pitch["band"], pitch["mix"], pitch["diff"], pitch["diff"], pitch["de"], pitch["dm"], ps]
    offsets = np.concatenate([[0], np.cumsum([ROWS * p for p in planes])])
    tables = [2 * band_steps16(getattr(plan, f).numel()) * BAND_TILE + 48
              for f in ("bell_takeoff", "luma_notch", "mix_lpf", "diff", "deemph", "demod_lpf")]
    n_ext4 = -(-(n + 2 * m) // 4) * 4
    total = int(offsets[-1]) + sum(tables) + 2 * n_ext4
    # v is staged in the v plane, inside the span the diff stage rewrites
    c_v = -(-(r["diff"][0] - org["de"]) // 4) * 4
    return {"pitch": pitch, "offsets": offsets, "bytes": 4 * total, "c_v": c_v, "org": org,
            "ranges": r, "w_in": w_in}


def encode_pipe_layout(plan) -> dict:
    """The pipelined encoder's shared memory (``secam_encode.cu::enc_layout``):
    the d, dl and two df/carrier planes of 8 rows, the Y staging rows, the
    ramp and the three tap tables."""
    n = plan.n_samples
    taps = {f: getattr(plan, f).numel() for f in ("comp_lpf", "preemph", "anticloche")}
    pitch = {f: _pitch8(max(_width(n, t, ENC_KW), _half(getattr(plan, f)) + n))
             for f, t in taps.items()}
    n4 = -(-n // 4) * 4
    planes = ROWS * (pitch["comp_lpf"] + pitch["preemph"] + 2 * pitch["anticloche"] + n4)
    tables = sum(2 * band_steps16(t) * BAND_TILE + 48 for t in taps.values())
    return {"pitch": pitch, "bytes": 4 * (planes + n4 + tables)}


def decode_span(plan) -> int:
    """The serial decoder's span: the whole line where its planes fit a
    block, else the widest of n / 2, n / 3, ... that fits (the wrapper's
    choice where the pipelined decoder's do not fit)."""
    n = plan.n_samples
    for parts in range(1, n + 1):
        span = -(-n // parts)
        if decode_geometry(plan, span)[1] <= SMEM_MAX:
            return span
    raise AssertionError("no span fits")


def model_decode(plan, comp: torch.Tensor, isr: torch.Tensor, span: int):
    """secam_decode.cu's arithmetic: (G, L, N) + (G*L,) -> (luma, v)."""
    g, l, n = comp.shape
    rows = g * l
    m, k_est = plan.fm_margin, plan.fm_luma_est
    n_ext = n + 2 * m
    c = comp.reshape(rows, n)
    pitch, _ = decode_geometry(plan, span)
    h = {k: _half(getattr(plan, f)) for k, f in _DEC_TAPS.items()}
    r_line = (isr != 0).reshape(rows, 1)
    fc, inv2pi, f0r, f0b, devr, devb = sk._decode_consts(plan)
    f0 = torch.where(r_line, f0r, f0b).float()
    dev = torch.where(r_line, devr, devb).float()
    lum_l = c[:, :k_est].sum(-1, keepdim=True) / k_est
    lum_r = c[:, n - k_est :].sum(-1, keepdim=True) / k_est
    carrier = torch.where(r_line, plan.fm_margin_carrier[1], plan.fm_margin_carrier[0])
    luma = torch.full((rows, n), float("nan"))
    v_out = torch.full((rows, n), float("nan"))
    cols = torch.arange(pitch)

    def place(org: int, lo: int, hi: int, vals: torch.Tensor) -> torch.Tensor:
        """A plane with column 0 at position org: vals at [lo, hi), 0 else."""
        p = torch.zeros(rows, pitch)
        p[:, lo - org : hi - org] = vals
        return p

    for p0 in range(0, n, span):
        r = decode_ranges(plan, p0, span)
        nt = {k: _tiles(r[k][1] - r[k][0], DEC_KW[k]) for k in r}
        (lo2, hi2), (lo3, hi3), (lo4, hi4), (lo5, hi5), (lo6, hi6) = (
            r[k] for k in ("band", "mix", "diff", "de", "dm"))
        # stage 1: the extended line, origin lo2 - h_band
        org = lo2 - h["band"]
        pos = org + cols
        e = torch.zeros(rows, pitch)
        left, mid, right = pos < m, (pos >= m) & (pos < m + n), pos >= m + n
        inside = (pos >= 0) & (pos < n_ext)
        e[:, left & inside] = lum_l + carrier[:, torch.clamp(pos[left & inside], 0, m - 1)]
        e[:, mid] = c[:, pos[mid] - m]
        e[:, right & inside] = lum_r.expand(rows, int((right & inside).sum()))
        # stage 2: takeoff and notch band share their B fragments
        take = fir16(e, plan.bell_takeoff_tiles, nt["band"])
        band = fir16(e, plan.luma_notch_tiles, nt["band"])
        luma[:, lo6 - m : hi6 - m] = (e[:, lo6 - org : hi6 - org]
                                      - band[:, lo6 - lo2 : hi6 - lo2])
        org_t = lo3 - h["mix"]
        t = place(org_t, lo2, hi2, take[:, : hi2 - lo2])
        # stage 3: i and q share the mix_lpf tiles; B = (2t) cos, (-2t) sin
        mix = torch.clamp(org_t + cols, 0, n_ext - 1)
        i = fir16((2.0 * t) * plan.mix_cos[mix], plan.mix_lpf_tiles, nt["mix"])
        q = fir16((-2.0 * t) * plan.mix_sin[mix], plan.mix_lpf_tiles, nt["mix"])
        org_iq = lo4 - h["diff"]
        pi = place(org_iq, lo3, hi3, i[:, : hi3 - lo3])
        pq = place(org_iq, lo3, hi3, q[:, : hi3 - lo3])
        # stage 4: di and dq share the diff tiles; the discriminator
        di = fir16(pi, plan.diff_tiles, nt["diff"])[:, : hi4 - lo4]
        dq = fir16(pq, plan.diff_tiles, nt["diff"])[:, : hi4 - lo4]
        iv, qv = pi[:, lo4 - org_iq : hi4 - org_iq], pq[:, lo4 - org_iq : hi4 - org_iq]
        a2 = torch.clamp_min(iv * iv + qv * qv, 1e-9)
        f = fc + (iv * dq - qv * di) / a2 * inv2pi
        v = place(lo5 - h["de"], lo4, hi4, (f - f0) / dev)
        # stage 5: de-emphasis; stage 6: the demod low-pass over the span
        vde = fir16(v, plan.deemph_tiles, nt["de"])[:, : hi5 - lo5]
        vo = fir16(place(lo6 - h["dm"], lo5, hi5, vde), plan.demod_lpf_tiles, nt["dm"])
        v_out[:, lo6 - m : hi6 - m] = vo[:, : hi6 - lo6]
    return luma.reshape(g, l, n), v_out.reshape(g, l, n)


# --- the tests --------------------------------------------------------------

_PLANS = {}


def _plan(n: int):
    if n not in _PLANS:
        _PLANS[n] = make_plan(SECAM(), n)
    return _PLANS[n]


def _inputs(plan, frames: int, lines: int, seed: int = 0):
    n = plan.n_samples
    gline = frame_line_index(plan, 3, frames, lines, "cpu")
    isr = sk.isr_col(gline)
    rng = np.random.default_rng(seed)
    rgb = torch.tensor(np.stack([smooth_scene(lines, n, seed=s) for s in range(frames)]),
                       dtype=torch.float32)
    ycc = apply_mat3(plan.rgb_to_ycc, rgb)
    chroma = torch.tensor(rng.uniform(-0.6, 0.6, (frames, 2, lines, n)), dtype=torch.float32)
    ycc_rand = torch.cat([ycc[:, :1], chroma], dim=1).contiguous()
    return gline, isr, ycc.contiguous(), ycc_rand


def _rgb(plan, luma, v, gline):
    dr, db = secam.pair(v, gline, "interp")
    return clamp01(apply_mat3(plan.ycc_to_rgb, torch.stack([luma, dr, db], dim=-3)))


@pytest.mark.parametrize("n,lines", [(720, 9), (1440, 5), (722, 3), (2160, 3)])
def test_model_encode_matches_plain(n, lines):
    """Held staging, held halo of the intermediate, per-row D'R/D'B, the
    warp scan and the anti-cloche, against encode_lines_plain at the
    kernel bound; odd line counts leave a ragged last tile of 8."""
    plan = _plan(n)
    _, isr, _, ycc_rand = _inputs(plan, 2, lines)
    err = float((model_encode(plan, ycc_rand, isr)
                 - sk.encode_lines_plain(plan, ycc_rand, isr)).abs().max())
    assert err <= ENC_ATOL / 4, err


@pytest.mark.parametrize("n,lines,spans", [(720, 9, 1), (1440, 5, 1), (720, 3, 3),
                                           (722, 3, 1), (2160, 3, 14)])
def test_model_decode_matches_plain(n, lines, spans):
    """The decoder's stages with their origins, zero edges and per-row
    constants, against demodulate_lines_plain on the decoded RGB and the
    luma, to the kernel bound; three spans recompute their halos, and at
    2160 the kernel's 14."""
    plan = _plan(n)
    gline, isr, ycc, _ = _inputs(plan, 2, lines, seed=1)
    comp = sk.encode_lines_plain(plan, ycc, isr)
    span = decode_span(plan) if spans == 1 else -(-n // spans)
    luma_m, v_m = model_decode(plan, comp, isr, span)
    luma_p, v_p = sk.demodulate_lines_plain(plan, comp, isr)
    assert torch.isfinite(luma_m).all() and torch.isfinite(v_m).all()
    assert float((luma_m - luma_p).abs().max()) <= DEC_ATOL / 10
    e_rgb = float((_rgb(plan, luma_m, v_m, gline) - _rgb(plan, luma_p, v_p, gline)).abs().max())
    assert e_rgb <= DEC_ATOL / 2, e_rgb


@pytest.mark.parametrize("n,pipelined,spans", [(720, True, 1), (722, True, 1),
                                               (1440, False, 1), (2160, False, 14)])
def test_decode_span_choice(n, pipelined, spans):
    """The pipelined decoder's six planes of a whole line fit a block at 720
    and 722 samples; at 1440 the serial decoder's three planes hold the
    whole line, and 2160 needs spans, each a smaller share of shared
    memory.  The pipelined encoder fits at 720 and 722, the
    serial one up to 2160."""
    plan = make_plan(SECAM(), n)
    assert (decode_pipe_layout(plan)["bytes"] <= SMEM_MAX) == pipelined
    assert (encode_pipe_layout(plan)["bytes"] <= SMEM_MAX) == pipelined
    span = decode_span(plan)
    assert -(-n // span) == spans
    assert decode_geometry(plan, span)[1] <= SMEM_MAX
    pitch, enc_smem = encode_geometry(plan)
    assert pitch % 32 == 4 and enc_smem <= SMEM_MAX


#: the widest lines each serial kernel takes: the taps, and with them the
#: halos, grow with the sampling rate, and every plane row holds at least a
#: whole line (the decoder's three planes, whatever its span; the
#: encoder's two)
WIDEST = {"decode": 2279, "encode": 2514}


@pytest.mark.parametrize("kernel", ["decode", "encode"])
def test_widest_lines(kernel):
    """The SECAM kernels take lines up to WIDEST samples and raise above
    (the JAX package takes any width): at the widest the decoder's planes
    of the least span (one sample) or the encoder's fit a block, one
    sample more and they do not."""
    n = WIDEST[kernel]
    for width, fits in ((n, True), (n + 1, False)):
        plan = make_plan(SECAM(), width)
        smem = decode_geometry(plan, 1)[1] if kernel == "decode" else encode_geometry(plan)[1]
        assert (smem <= SMEM_MAX) == fits, (width, smem)


@pytest.mark.parametrize("ntaps,n", [(31, 61), (129, 720), (193, 816), (257, 816),
                                     (515, 1632)])
def test_band_tiles16_against_np_convolve(ntaps, n):
    """The 16x8 tiles summed in float64 equal np.convolve 'same' on random
    asymmetric taps (a mirrored or shifted tile passes every symmetric tap
    set), and the emulated three passes meet the FIR bound of the card
    tests, on a ragged last tile of outputs."""
    rng = np.random.default_rng(ntaps + n)
    taps = rng.normal(size=ntaps) / ntaps
    x = rng.normal(size=(8, n)).astype(np.float32)
    half = (ntaps - 1) // 2
    nt = -(-n // OUT)
    steps = band_steps16(ntaps)
    width = BAND_TILE * (2 * nt + steps - 2)
    plane = np.zeros((8, width))
    plane[:, half : half + n] = x
    mats = band_tile16_matrices(taps)
    assert mats.shape == (steps, OUT, BAND_TILE)
    assert band_tiles16(taps).shape == (BAND_TILE * steps + 24, 2)
    chunks = plane.reshape(8, -1, BAND_TILE)
    exact = sum(chunks[:, s : s + 2 * nt - 1 : 2] @ mats[s].T for s in range(steps))
    ref = _np_same(x.astype(np.float64), taps)
    np.testing.assert_allclose(exact.reshape(8, -1)[:, :n], ref, atol=1e-12, rtol=0)
    got = fir16(torch.tensor(plane, dtype=torch.float32), torch.tensor(band_tiles16(taps)), nt)
    np.testing.assert_allclose(got[:, :n].numpy(), ref, atol=FIR_ATOL, rtol=0)


def test_band_tiles16_are_tf32():
    """Every table value has its low 13 mantissa bits clear, and the tiles
    read from it as the kernel reads them rebuild the float64 tiles, hi + lo
    to 2^-22 of their magnitude."""
    taps = np.random.default_rng(5).normal(size=193)
    tiles = band_tiles16(taps)
    assert tiles.shape == (BAND_TILE * band_steps16(193) + 24, 2)
    assert not np.any(tiles.view(np.uint32) & np.uint32(0x1FFF))
    hi, lo = (m.numpy() for m in _tiles_as_mats(torch.tensor(tiles)))
    mats = band_tile16_matrices(taps)
    assert np.all(np.abs(hi + lo - mats) <= 2.0**-22 * np.abs(mats))


@pytest.mark.parametrize("n", [720, 1440])
def test_secam_tiles_survive_plan_from_numpy(n):
    """The JAX plan's taps, carried across, give the same 16x8 tile buffers
    as the port's own plan, and those are band_tiles16 of the float64 taps."""
    # imported here: the card tests import this module's layout model on a
    # machine without JAX
    from color_modem_tpu.modem.plan import make_plan as jax_make_plan
    from color_modem_tpu.standards import SECAM as JAX_SECAM

    jp = jax_make_plan(JAX_SECAM(), n)
    carried, own = plan_from_numpy(jp), make_plan(SECAM(), n)
    for field in FM_TAPS:
        tiles = getattr(carried, field + "_tiles")
        assert tiles.dtype == torch.float32
        assert tiles.shape == (BAND_TILE * band_steps16(len(getattr(jp, field))) + 24, 2)
        np.testing.assert_array_equal(tiles.numpy(), band_tiles16(getattr(jp, field)))
        np.testing.assert_array_equal(tiles.numpy(), getattr(own, field + "_tiles").numpy())


@pytest.mark.parametrize("n", [720, 722])
def test_pipelined_layouts(n):
    """Every plane of the pipelined kernels is as wide as the columns its
    reader's FIR reads (fir16's bound) and its writer writes, rows pad to
    pitch % 8 == 4 (ldmatrix without bank conflicts) and start on 16 bytes
    (bulk stores), and the v staging columns lie inside the span the diff
    stage rewrites every tile, so the v plane's zero edges stay."""
    plan = make_plan(SECAM(), n)
    d = decode_pipe_layout(plan)
    r, org = d["ranges"], d["org"]
    for k in ("band", "mix", "diff", "de", "dm"):
        assert d["pitch"][k] >= d["w_in"][k] and d["pitch"][k] % 8 == 4
    assert d["pitch"]["band"] >= n + plan.fm_margin - org["band"]  # ext holds the composite
    assert all(o % 4 == 0 for o in d["offsets"])
    assert r["diff"][0] - org["de"] <= d["c_v"]
    assert d["c_v"] + n <= r["diff"][1] - org["de"]
    e = encode_pipe_layout(plan)
    assert all(p % 8 == 4 for p in e["pitch"].values())
    assert e["bytes"] <= SMEM_MAX

