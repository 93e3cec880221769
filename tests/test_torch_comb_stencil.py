"""The line-axis comb stencil of 'comb2' and 'comb3' (``kernels/comb.py``) on
the CPU.

A CUDA tensor goes through the hand-written pass ``csrc/comb_stencil.cu``; a
CPU tensor through the plain version ``separate/comb.py::line_stencil``,
the composition ``stencil_signal`` always ran.  These tests hold the CPU
path to that composition bit for bit, line by line at the edges, at NTSC's
spacing (1 line) and PAL's (2), and pin which decoders of
``frame/pipeline.py::_demodulate_qam`` take the pass; the kernel against
the plain version runs on the card in ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_modem_tpu.modem.plan import make_plan as jax_make_plan
from color_modem_tpu.separate.comb import stencil_signal as jax_stencil_signal
from color_modem_tpu.standards import ALL_STANDARDS as JAX_STANDARDS
from color_modem_tpu_torch import ALL_STANDARDS
from color_modem_tpu_torch.frame import pipeline
from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
from color_modem_tpu_torch.kernels import comb as comb_k
from color_modem_tpu_torch.kernels import launch_counts, reset_launches
from color_modem_tpu_torch.kernels import qam as qam_k
from color_modem_tpu_torch.kernels.build import CSRC_DIR, NVCC_FLAGS, SIGNATURES
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.separate.comb import line_stencil, stencil_signal
from color_modem_tpu_torch.standards.decoders import comb_spacing
from color_modem_tpu_torch.utils.testimages import smooth_scene
from torch_threads import one_torch_thread  # noqa: F401

#: samples of the stencil tests' lines (the plans, which the stencil reads
#: only for the spacing, take 720)
N = 24
#: NTSC combs at 1 line, PAL at 2
SPACED = [("ntsc", 1), ("pal", 2)]
FORMS = ["comb2", "comb3"]
_PLANS = {}


def plan_of(name, n=720):
    if (name, n) not in _PLANS:
        _PLANS[name, n] = make_plan(ALL_STANDARDS[name](), n)
    return _PLANS[name, n]


def bits(t):
    return t.contiguous().view(torch.int32)


def _wild(seed, shape):
    """Composite values beyond [0, 1] on both sides, with NaNs and infinities."""
    x = torch.tensor(np.random.default_rng(seed).normal(0.5, 1.0, shape), dtype=torch.float32)
    flat = x.view(-1)
    flat[[3, 17 % flat.numel(), 29 % flat.numel()]] = float("nan")
    flat[[11 % flat.numel()]] = float("inf")
    return x


def _line_by_line(x, p, decoder):
    """The stencil written out per line from the edge rules of
    ``separate/stencil.py``: above the top line l < p takes x[p - l], below
    the bottom line l >= L - p takes x[2 (L - 1) - l - p]."""
    lines = x.shape[-2]
    rows = []
    for l in range(lines):
        prev = x[..., l - p if l >= p else p - l, :]
        cur = x[..., l, :]
        if decoder == "comb2":
            rows.append((cur - prev) / 2.0)
            continue
        nxt = x[..., l + p if l + p <= lines - 1 else 2 * (lines - 1) - l - p, :]
        rows.append((2.0 * cur - prev - nxt) / 4.0)
    return torch.stack(rows, dim=-2)


@pytest.mark.parametrize("decoder", FORMS)
@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
@pytest.mark.parametrize("name,p", SPACED)
def test_cpu_path_is_stencil_signal(name, p, lead, decoder):
    """Bit for bit ``stencil_signal``, NaNs and infinities included, on an
    unbatched frame and on batched blocks, at a full frame's lines and at
    odd counts."""
    plan = plan_of(name)
    assert comb_spacing(plan.cfg) == p
    for lines in (plan.cfg.active_lines, 2 * p + 1, 37):
        x = _wild(lines + len(lead), (*lead, lines, N))
        got = comb_k.comb_stencil(x, p, decoder)
        assert got.shape == x.shape
        assert torch.equal(bits(got), bits(stencil_signal(plan, x, decoder)))
        assert torch.equal(bits(got), bits(line_stencil(x, p, decoder)))
        assert torch.isnan(got).any()


@pytest.mark.parametrize("decoder", FORMS)
@pytest.mark.parametrize("name,p", SPACED)
def test_edge_lines_one_by_one(name, p, decoder):
    """Every line of the fewest lines each spacing takes (p + 1) and of a
    few more, against the edge rules written out line by line."""
    for lines in range(p + 1, 2 * p + 4):
        x = torch.rand((2, lines, N), generator=torch.Generator().manual_seed(lines))
        got = comb_k.comb_stencil(x, p, decoder)
        want = _line_by_line(x, p, decoder)
        for l in range(lines):
            assert torch.equal(bits(got[:, l]), bits(want[:, l])), (lines, l)


@pytest.mark.parametrize("decoder", FORMS)
@pytest.mark.parametrize("name,p", SPACED)
def test_stencil_matches_jax(name, p, decoder):
    """The JAX package's ``stencil_signal`` on the same composite."""
    lines = 2 * p + 5
    x = np.random.default_rng(p).uniform(-0.4, 1.3, (2, lines, N)).astype(np.float32)
    jp = jax_make_plan(JAX_STANDARDS[name](), 720)
    want = np.asarray(jax_stencil_signal(jp, jnp.asarray(x), decoder))
    got = comb_k.comb_stencil(torch.tensor(x), p, decoder).numpy()
    assert float(np.abs(got - want).max()) == 0.0


def test_a_nan_reaches_the_lines_that_read_it():
    """At p = 1 a NaN on line 2 reaches the lines that read line 2: comb2's
    lines 2 and 3, comb3's lines 1, 2 and 3."""
    x = torch.rand((1, 6, N), generator=torch.Generator().manual_seed(3))
    x[0, 2, 5] = float("nan")
    nan2 = torch.isnan(comb_k.comb_stencil(x, 1, "comb2"))[0, :, 5]
    nan3 = torch.isnan(comb_k.comb_stencil(x, 1, "comb3"))[0, :, 5]
    assert nan2.tolist() == [False, False, True, True, False, False]
    assert nan3.tolist() == [False, True, True, True, False, False]


def test_wrapper_checks_its_inputs():
    x = torch.zeros((2, 4, N))
    with pytest.raises(TypeError):
        comb_k.comb_stencil(x.double(), 1, "comb3")
    with pytest.raises(ValueError, match="decoder"):
        comb_k.comb_stencil(x, 1, "comb3d")
    with pytest.raises(ValueError, match="p: expected"):
        comb_k.comb_stencil(x, 3, "comb3")
    with pytest.raises(ValueError, match=r"\(\.\.\., L, N\)"):
        comb_k.comb_stencil(torch.zeros(N), 1, "comb2")
    with pytest.raises(ValueError, match="2 or more lines"):
        comb_k.comb_stencil(torch.zeros((2, 1, N)), 1, "comb2")
    with pytest.raises(ValueError, match="3 or more lines"):
        comb_k.comb_stencil(torch.zeros((2, 2, N)), 2, "comb3")
    with pytest.raises(ValueError, match="device"):
        comb_k.comb_stencil(x.to("meta"), 1, "comb3")
    assert comb_k.comb_stencil(torch.zeros((0, 4, N)), 1, "comb3").shape == (0, 4, N)


@pytest.mark.parametrize("decoder", FORMS)
def test_wrapper_accepts_a_non_contiguous_input(decoder):
    x = torch.rand((N, 9, 3), generator=torch.Generator().manual_seed(5)).transpose(0, 2)
    assert not x.is_contiguous()
    got = comb_k.comb_stencil(x, 2, decoder)
    assert torch.equal(bits(got), bits(comb_k.comb_stencil(x.contiguous(), 2, decoder)))


@pytest.mark.parametrize("decoder,form", [("comb2", 2), ("comb3", 3)])
def test_call_passes_frames_lines_samples_spacing_and_form(decoder, form):
    x = torch.zeros((2, 5, 7, 9))
    out = torch.empty_like(x)
    tensors, scalars = comb_k.comb_stencil_call(x, out, 2, decoder)
    assert tensors[0] is x and tensors[1] is out and len(tensors) == 2
    assert scalars == (10, 7, 9, 2, form)
    assert len(SIGNATURES["comb_stencil"]) == len(tensors) + len(scalars) + 1


def test_kernel_source_keeps_the_composition_order():
    """What the CPU can check of ``csrc/comb_stencil.cu``: the plain
    composition's steps as separate round-to-nearest operations in its
    order, the exact halving and quartering, the reflections of
    ``separate/stencil.py``, no shared memory (so no poison block for the
    sanitizer's build), and a build without fast math."""
    text = (CSRC_DIR / "comb_stencil.cu").read_text()
    assert "return __fmul_rn(0.5f, __fsub_rn(x, prev));" in text
    assert "return __fmul_rn(0.25f, __fsub_rn(__fsub_rn(__fmul_rn(2.0f, x), prev), next));" in text
    assert "r = r < 0 ? -r : r;" in text and "r = r > lines - 1 ? 2 * (lines - 1) - r : r;" in text
    assert "__shared__" not in text and "CMT_POISON" not in text
    assert not any("fast_math" in f or "fmad=false" in f for f in NVCC_FLAGS)


# --- which decoders take the pass (frame/pipeline.py::_demodulate_qam) -----------------

def _watch(monkeypatch):
    """Record each call of the pass and what reaches the decode kernel, in
    the kernel backend's row of ``pipeline.STAGES``."""
    seen = {"stencil": [], "sep": []}
    kernel = pipeline.STAGES["kernel"]
    real_stencil, real_decode = kernel.line_stencil, kernel.qam_demodulate

    def stencil(x, p, decoder):
        seen["stencil"].append((p, decoder))
        return real_stencil(x, p, decoder)

    def decode(plan, sep, comp, gline):
        seen["sep"].append((sep, comp))
        return real_decode(plan, sep, comp, gline)

    monkeypatch.setitem(pipeline.STAGES, "kernel",
                        kernel._replace(line_stencil=stencil, qam_demodulate=decode))
    return seen


ROUTES = [("ntsc", "comb2"), ("ntsc", "comb3"), ("pal", "comb2"), ("pal", "comb3"),
          ("ntsc", "notch"), ("pal", "delayline"), ("ntsc", "avg"), ("niir", "avg"),
          ("ntsc", "comb3d"), ("pal", "comb3d"), ("ntsc", "combA"), ("pal", "comb3dA")]


@pytest.mark.parametrize("name,decoder", ROUTES)
def test_which_decoders_take_the_pass(name, decoder, monkeypatch):
    """On the kernel backend 'comb2' and 'comb3' take the pass once, at the
    plan's spacing; 'notch', 'delayline' and 'avg' hand the composite itself
    to the decode kernel, uncopied; 'comb3d' its plain frame stencil; the
    adaptive combs separate plainly and launch no decode.  The plain
    backend takes neither."""
    plan = plan_of(name)
    seen = _watch(monkeypatch)
    comp = torch.rand((4, 8, 720), generator=torch.Generator().manual_seed(1))
    gline = frame_line_index(plan, 3, 4, 8, "cpu")
    pipeline._demodulate_qam(plan, comp, gline, decoder, pipeline.STAGES["plain"])
    assert seen == {"stencil": [], "sep": []}
    pipeline._demodulate_qam(plan, comp, gline, decoder, pipeline.STAGES["kernel"])
    if decoder in ("comb2", "comb3"):
        assert seen["stencil"] == [(comb_spacing(plan.cfg), decoder)]
    else:
        assert seen["stencil"] == []
    if decoder in ("combA", "comb3dA"):
        assert seen["sep"] == []
        return
    (sep, got_comp), = seen["sep"]
    assert got_comp is comp
    if decoder in ("notch", "delayline", "avg"):
        assert sep is comp
    else:
        assert torch.equal(bits(sep), bits(stencil_signal(plan, comp, decoder)))


@pytest.mark.parametrize("name,decoder", [("ntsc", "comb2"), ("ntsc", "comb3"),
                                          ("pal", "comb2"), ("pal", "comb3")])
def test_comb_decodes_are_unchanged_and_launch_nothing_on_the_cpu(name, decoder):
    """On the CPU the kernel backend's comb decode is, bit for bit, the
    decode kernel's plain version on ``stencil_signal``, and no kernel
    launches."""
    plan = plan_of(name)
    lines = plan.cfg.active_lines // 8
    rgb = torch.tensor(smooth_scene(lines, 720, seed=3), dtype=torch.float32)
    rgb = rgb[None].repeat(2, 1, 1, 1)
    gline = frame_line_index(plan, 9, 2, lines, "cpu")
    reset_launches()
    comp = pipeline.encode_block(plan, rgb, gline, "kernel")
    got = pipeline._demodulate_qam(plan, comp, gline, decoder, pipeline.STAGES["kernel"])
    want = qam_k.demodulate_separated(plan, stencil_signal(plan, comp, decoder), comp, gline)
    assert torch.equal(bits(got), bits(want))
    make_pipeline(plan, decoder, "kernel", "cpu")[2](rgb, 9)
    assert set(launch_counts().values()) == {0}
