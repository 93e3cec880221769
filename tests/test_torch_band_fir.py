"""The arithmetic of the tensor-core FIR (``csrc/band_fir.cuh``) on the CPU.

The kernel cannot run here, so these tests hold its design: the host-built
band tiles (``kernels/tiles.py::band_tiles``) summed as ``sum_s X_{t+s} B_s``
equal ``np.convolve(mode='same')`` on asymmetric taps (a mirrored or
shifted tile passes every symmetric QAM tap set); the TF32 hi/lo split;
an emulation of the three-pass TF32 product, rounding A to TF32 by bits as
the kernel does, against the plain encode and decode at the kernels'
bounds (2e-5 encode, 5e-4 decode); and the tiles carried by
``plan_from_numpy``.
"""

import numpy as np
import pytest
import torch

from color_modem_tpu.modem.plan import make_plan as jax_make_plan
from color_modem_tpu.standards import ALL_STANDARDS as JAX_STANDARDS
from color_modem_tpu_torch import ALL_STANDARDS
from color_modem_tpu_torch.kernels.tiles import (
    BAND_TILE,
    band_steps,
    band_tile_matrices,
    band_tiles,
    split_tf32_host,
)
from color_modem_tpu_torch.frame.pipeline import frame_line_index
from color_modem_tpu_torch.kernels import qam as qk
from color_modem_tpu_torch.modem.plan import make_plan, plan_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

QAM_NAMES = sorted(k for k, f in ALL_STANDARDS.items() if not f().is_fm)
ENC_ATOL, DEC_ATOL = 2e-5, 5e-4
#: the card test's bound on the FIR alone (tests/test_torch_kernels_cuda.py)
FIR_ATOL = 2e-6


def _np_same(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Per-row np.convolve 'same' with zero edges, also for taps longer
    than the line."""
    h = (len(taps) - 1) // 2
    n = x.shape[-1]
    return np.stack([np.convolve(np.pad(r, h), taps, "same")[h : h + n] for r in x])


def _tiles_as_mats(tiles: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(S, 32, 4) fragments -> (S, 8, 8) hi and lo tiles ``B_s[u, r]``."""
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    hi = np.zeros((tiles.shape[0], BAND_TILE, BAND_TILE), np.float32)
    lo = np.zeros_like(hi)
    hi[:, q, g], hi[:, q + 4, g] = tiles[..., 0], tiles[..., 1]
    lo[:, q, g], lo[:, q + 4, g] = tiles[..., 2], tiles[..., 3]
    return hi, lo


def _chunks(x, ntaps: int):
    """(L, n) -> (L, n_tiles + S - 1, 8) chunks of the halo-staged line
    ``x~[i] = x[i - half]`` (zero outside), and the tile count."""
    lib = np if isinstance(x, np.ndarray) else torch
    n, steps, h = x.shape[-1], band_steps(ntaps), (ntaps - 1) // 2
    nt = -(-n // BAND_TILE)
    width = BAND_TILE * (nt + steps - 1)
    if lib is np:
        xs = np.pad(x, ((0, 0), (h, width - n - h)))
    else:
        xs = torch.nn.functional.pad(x, (h, width - n - h))
    return xs.reshape(x.shape[0], nt + steps - 1, BAND_TILE), nt


def tile_fir64(x: np.ndarray, mats: np.ndarray, ntaps: int) -> np.ndarray:
    """sum_s X_{t+s} B_s in float64: the kernel's banded product, exactly."""
    chunks, nt = _chunks(x.astype(np.float64), ntaps)
    out = sum(chunks[:, s : s + nt] @ mats[s] for s in range(mats.shape[0]))
    return out.reshape(x.shape[0], -1)[:, : x.shape[-1]]


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32, ties away from zero, by bits (cvt.rna.tf32.f32)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 part of a float32 that the tensor core reads."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def emulated_fir(x: torch.Tensor, tiles: torch.Tensor, ntaps: int) -> torch.Tensor:
    """The kernel's three TF32 passes, emulated: A split in float32 as the
    kernel splits it (hi rounded to TF32, lo = a - hi read as TF32), each
    step's products exact (float64) and the accumulator float32."""
    chunks, nt = _chunks(x, ntaps)
    a_hi = _round_tf32(chunks)
    a_lo = _trunc_tf32(chunks - a_hi)
    b_hi, b_lo = (torch.tensor(m, dtype=torch.float64)
                  for m in _tiles_as_mats(tiles.numpy()))
    a_hi, a_lo = a_hi.double(), a_lo.double()
    acc = torch.zeros(x.shape[0], nt, BAND_TILE, dtype=torch.float32)
    for s in range(b_hi.shape[0]):
        step = (a_lo[:, s : s + nt] @ b_hi[s] + a_hi[:, s : s + nt] @ b_lo[s]
                + a_hi[:, s : s + nt] @ b_hi[s])
        acc = (acc.double() + step).float()
    return acc.reshape(x.shape[0], -1)[:, : x.shape[-1]]


@pytest.mark.parametrize("n", [61, 97, 720, 722, 1440])
@pytest.mark.parametrize("ntaps", [31, 129, 259])
def test_band_tiles_sum_to_np_convolve(ntaps, n):
    """Exact tiles to 1e-12, the hi + lo fragments the kernel loads to the
    card test's bound, on random asymmetric taps; (61, 129), (61, 259) and
    (97, 259) have taps longer than the line."""
    rng = np.random.default_rng(ntaps * 1000 + n)
    taps = rng.normal(size=ntaps) / ntaps
    x = rng.normal(size=(5, n))
    ref = _np_same(x, taps)
    assert band_tile_matrices(taps).shape == (band_steps(ntaps), 8, 8)
    np.testing.assert_allclose(tile_fir64(x, band_tile_matrices(taps), ntaps), ref,
                               atol=1e-12, rtol=0)
    hi, lo = _tiles_as_mats(band_tiles(taps))
    split = hi.astype(np.float64) + lo.astype(np.float64)
    np.testing.assert_allclose(tile_fir64(x, split, ntaps), ref, atol=FIR_ATOL / 4, rtol=0)


def test_band_steps_match_the_design():
    """S = (T + 6) // 8 + 1: 17 tiles for 129 taps, 34 for 259."""
    assert band_steps(129) == 17 and band_steps(259) == 34
    for t in (3, 31, 129, 131, 259):
        mats = band_tile_matrices(np.arange(1.0, t + 1))
        # every tap appears in every output column r, once
        for r in range(8):
            col = np.sort(np.concatenate([m[:, r] for m in mats]))
            np.testing.assert_array_equal(col[col != 0], np.arange(1.0, t + 1))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
def test_split_tf32_hi_lo(scale):
    """hi is TF32 (low 13 mantissa bits zero), lo too, and hi + lo rebuilds
    the value to 2^-22 of its magnitude."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=4096) * scale
    hi, lo = split_tf32_host(v)
    for part in (hi, lo):
        assert part.dtype == np.float32
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    err = np.abs(hi.astype(np.float64) + lo.astype(np.float64) - v)
    assert np.all(err <= 2.0**-22 * np.abs(v))
    tiles = band_tiles(rng.normal(size=129))
    assert not np.any(tiles.view(np.uint32) & np.uint32(0x1FFF))


def _cols_and_ycc(plan, frames, lines, seed=0):
    n = plan.n_samples
    rng = np.random.default_rng(seed)
    ycc = np.stack([rng.uniform(0.0, 1.0, (frames, lines, n)),
                    rng.uniform(-0.6, 0.6, (frames, lines, n)),
                    rng.uniform(-0.6, 0.6, (frames, lines, n))], axis=1)
    ycc = torch.tensor(ycc, dtype=torch.float32)
    cols = qk.phase_cols(plan, frame_line_index(plan, 12345, frames, lines, "cpu"))
    return ycc, cols


def _carrier(plan, cols, g, l):
    return qk._carrier(cols[:, 0].reshape(g, l, 1), plan)


@pytest.mark.parametrize("name,n", [("ntsc", 720), ("pal", 1440), ("niir", 720)])
def test_emulated_three_pass_encode(name, n):
    """The encode kernel's arithmetic with emulated TF32 FIRs against the
    plain encode, to the kernel bound (129 taps at 720, 259 at 1440)."""
    plan = make_plan(ALL_STANDARDS[name](), n)
    ntaps = plan.c1_lpf.numel()
    g, l = 2, 5
    ycc, cols = _cols_and_ycc(plan, g, l)
    c1f = emulated_fir(ycc[:, 1].reshape(-1, n), plan.c1_lpf_tiles, ntaps).reshape(g, l, n)
    c2f = emulated_fir(ycc[:, 2].reshape(-1, n), plan.c2_lpf_tiles, ntaps).reshape(g, l, n)
    sin, cos = _carrier(plan, cols, g, l)
    vs, ref = (cols[:, k].reshape(g, l, 1) for k in (1, 2))
    chroma = c1f * sin + vs * c2f * cos
    chroma = ref * (qk._ref_amplitude(plan) * sin) + (1.0 - ref) * chroma
    got = ycc[:, 0] + chroma
    err = float((got - qk.encode_lines_plain(plan, ycc, cols)).abs().max())
    assert err <= ENC_ATOL / 4, err


@pytest.mark.parametrize("name,n", [("ntsc", 720), ("pal", 1440)])
def test_emulated_three_pass_decode_chain(name, n):
    """Band-pass, mix and both low-passes with emulated TF32 FIRs against
    the plain decode, to the kernel bound."""
    plan = make_plan(ALL_STANDARDS[name](), n)
    ntaps = plan.c1_lpf.numel()
    g, l = 2, 5
    ycc, cols = _cols_and_ycc(plan, g, l, seed=1)
    comp = qk.encode_lines_plain(plan, ycc, cols)
    flat = comp.reshape(-1, n)
    cb = emulated_fir(flat, plan.chroma_bpf_tiles, ntaps).reshape(g, l, n)
    sin, cos = _carrier(plan, cols, g, l)
    vs = cols[:, 1].reshape(g, l, 1)
    c1 = emulated_fir((2.0 * cb * sin).reshape(-1, n), plan.c1_lpf_tiles, ntaps)
    c2 = emulated_fir((2.0 * cb * cos).reshape(-1, n), plan.c2_lpf_tiles, ntaps)
    got = torch.stack([comp - cb, c1.reshape(g, l, n), vs * c2.reshape(g, l, n)], dim=1)
    err = float((got - qk.decode_lines_plain(plan, comp, comp, cols)).abs().max())
    assert err <= DEC_ATOL / 10, err


@pytest.mark.parametrize("ntaps,n", [(129, 720), (259, 1440), (31, 61)])
def test_emulated_fir_alone_meets_the_card_bound(ntaps, n):
    """The emulated three passes against np.convolve on asymmetric taps at
    the card test's 2e-6, 17 lines (a ragged last tile of 16)."""
    rng = np.random.default_rng(ntaps + n)
    taps = rng.normal(size=ntaps) / ntaps
    x = rng.normal(size=(17, n)).astype(np.float32)
    got = emulated_fir(torch.tensor(x), torch.tensor(band_tiles(taps)), ntaps)
    np.testing.assert_allclose(got.numpy(), _np_same(x.astype(np.float64), taps),
                               atol=FIR_ATOL, rtol=0)


@pytest.mark.parametrize("name", QAM_NAMES)
def test_band_tiles_survive_plan_from_numpy(name):
    """The JAX plan's taps, carried across, give the same tile buffers as
    the port's own plan, and those are band_tiles of the float64 taps."""
    jp = jax_make_plan(JAX_STANDARDS[name](), 720)
    carried, own = plan_from_numpy(jp), make_plan(ALL_STANDARDS[name](), 720)
    for field in ("c1_lpf", "c2_lpf", "chroma_bpf"):
        tiles = getattr(carried, field + "_tiles")
        assert tiles.dtype == torch.float32
        assert tiles.shape == (band_steps(len(getattr(jp, field))), 32, 4)
        np.testing.assert_array_equal(tiles.numpy(), band_tiles(getattr(jp, field)))
        np.testing.assert_array_equal(tiles.numpy(), getattr(own, field + "_tiles").numpy())
