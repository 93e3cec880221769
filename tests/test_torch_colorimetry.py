"""The colour matrices (``dsp/colorimetry.py``, ``kernels/colorimetry.py``)
on the CPU.

On a CUDA tensor the wrappers go through the hand-written pass
``csrc/colour_matrix.cu``, the decoder's clamp inside it; on a CPU tensor
through the plain version (``dsp/colorimetry.py``), which is the product
and two ``addcmul_`` the port always ran, followed by ``torch.clamp``.  These tests hold the CPU path to that composition bit
for bit, and to the JAX package's ``apply_mat3``; the kernel against the
plain version runs on the card in ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_modem_tpu.dsp.colorimetry import apply_mat3 as jax_apply_mat3
from color_modem_tpu_torch import ALL_STANDARDS
from color_modem_tpu_torch.dsp.colorimetry import apply_mat3, clamp01, delayline_mat3
from color_modem_tpu_torch.frame import pipeline
from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
from color_modem_tpu_torch.kernels import colorimetry as ck
from color_modem_tpu_torch.kernels import launch_counts, reset_launches
from color_modem_tpu_torch.kernels import qam as qk
from color_modem_tpu_torch.kernels import secam as sk
from color_modem_tpu_torch.modem import qam, secam
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.separate.delayline import average_with_neighbor
from color_modem_tpu_torch.utils.testimages import smooth_scene
from torch_threads import one_torch_thread  # noqa: F401

N = 720
MATRICES = ["rgb_to_ycc", "ycc_to_rgb"]
_PLANS = {}


def plan_of(name):
    if name not in _PLANS:
        _PLANS[name] = make_plan(ALL_STANDARDS[name](), N)
    return _PLANS[name]


def bits(t):
    return t.contiguous().view(torch.int32)


def _composition(mat, x):
    """The colour matrix as the port computed it before the kernel: a
    product broadcasting one plane into three, then two ``addcmul_``."""
    m = mat.to(device=x.device, dtype=x.dtype).reshape(3, 3, 1, 1)
    y = x[..., 0:1, :, :] * m[:, 0]
    y.addcmul_(x[..., 1:2, :, :], m[:, 1])
    return y.addcmul_(x[..., 2:3, :, :], m[:, 2])


def _wild(seed, shape=(2, 3, 5, 33)):
    """Values beyond [0, 1] on both sides, with NaNs and infinities."""
    x = torch.tensor(np.random.default_rng(seed).normal(0.5, 1.0, shape), dtype=torch.float32)
    flat = x.view(-1)
    flat[[3, 40, 77]] = float("nan")
    flat[[5, 51]] = float("inf")
    flat[[9, 88]] = float("-inf")
    return x


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("name", sorted(ALL_STANDARDS))
def test_clamp_inside_equals_clamp01_after(name, matrix):
    """``apply_mat3(..., clamp=True)`` on the CPU is ``clamp01(apply_mat3(...))``
    and ``apply_mat3`` the product and two ``addcmul_``, bit for bit, NaN
    and infinities included."""
    mat = getattr(plan_of(name), matrix)
    x = _wild(len(name) + len(matrix))
    y = apply_mat3(mat, x)
    assert torch.equal(bits(y), bits(_composition(mat, x)))
    clamped = apply_mat3(mat, x, clamp=True)
    assert torch.equal(bits(clamped), bits(clamp01(y)))
    assert torch.isnan(clamped).any() and not torch.isinf(clamped).any()


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("name", sorted(ALL_STANDARDS))
def test_apply_mat3_matches_jax_per_standard(name, matrix):
    mat = getattr(plan_of(name), matrix)
    x = np.random.default_rng(7).uniform(-0.6, 1.0, (2, 3, 4, N)).astype(np.float32)
    ref = np.asarray(jax_apply_mat3(jnp.asarray(mat.numpy()), jnp.asarray(x)))
    np.testing.assert_allclose(apply_mat3(mat, torch.tensor(x)).numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(apply_mat3(mat, torch.tensor(x), clamp=True).numpy(),
                               np.clip(ref, 0.0, 1.0), atol=1e-6)


def test_wrapper_checks_its_inputs():
    mat = plan_of("ntsc").rgb_to_ycc
    x = torch.zeros((2, 3, 4, 8))
    with pytest.raises(TypeError):
        ck.colour_matrix(mat, x.double())
    with pytest.raises(ValueError, match=r"\(\.\.\., 3, L, N\)"):
        ck.colour_matrix(mat, torch.zeros((2, 4, 4, 8)))
    with pytest.raises(ValueError, match=r"\(\.\.\., 3, L, N\)"):
        ck.colour_matrix(mat, torch.zeros((3, 8)))
    with pytest.raises(ValueError, match="mat"):
        ck.colour_matrix(mat[:, :2], x)
    with pytest.raises(ValueError, match="device"):
        ck.colour_matrix(mat, x.to("meta"))


@pytest.mark.parametrize("clamp", [False, True])
def test_wrapper_accepts_a_non_contiguous_input(clamp):
    """A transposed view, and a slice of every other sample, give what
    their contiguous copies give."""
    mat = plan_of("pal").ycc_to_rgb
    base = _wild(3, (2, 3, 34, 9))
    for x in (base.transpose(-2, -1), base[..., ::2]):
        assert not x.is_contiguous()
        assert torch.equal(bits(ck.colour_matrix(mat, x, clamp)),
                           bits(ck.colour_matrix(mat, x.contiguous(), clamp)))
    empty = ck.colour_matrix(mat, torch.zeros((0, 3, 4, 8)), clamp)
    assert empty.shape == (0, 3, 4, 8)


@pytest.mark.parametrize("name,decoder", [("ntsc", "comb3"), ("secam", "interp")])
def test_cpu_roundtrip_launches_no_colour_matrix(name, decoder):
    reset_launches()
    _, _, rt = make_pipeline(plan_of(name), decoder, "kernel", "cpu")
    rgb = smooth_scene(8, N, seed=2).astype(np.float32)[None]
    rt(rgb, 0)
    assert launch_counts()["colour_matrix"] == 0
    assert set(launch_counts().values()) == {0}


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_cpu_apply_mat3_is_the_plain_version_on_either_backend(backend, clamp):
    """On the CPU both backends' colour matrix (``pipeline.STAGES``) is the
    plain version, bit for bit."""
    mat, x = plan_of("ntsc").ycc_to_rgb, _wild(5)
    assert torch.equal(bits(pipeline.STAGES[backend].colour_matrix(mat, x, clamp)),
                       bits(apply_mat3(mat, x, clamp)))


BLOCKS = [("ntsc", "notch"), ("ntsc", "comb3"), ("ntsc", "combA"), ("pal", "delayline"),
          ("secam", "interp"), ("niir", "avg"), ("secam", "avg"), ("ntsc", "comb2"),
          ("pal", "comb2"), ("pal", "comb3")]


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("name,decoder", BLOCKS)
def test_blocks_equal_the_composition_they_replace(name, decoder, backend):
    """``encode_block`` and ``decode_block`` on the CPU give, bit for bit,
    the colour matrix as the product and two ``addcmul_`` around the same
    modem, and ``clamp01`` after the decoder's."""
    plan = plan_of(name)
    rgb = torch.tensor(smooth_scene(8, N, seed=4), dtype=torch.float32)[None].repeat(2, 1, 1, 1)
    gline = frame_line_index(plan, 5, 2, 8, "cpu")
    ycc = _composition(plan.rgb_to_ycc, rgb)
    if plan.cfg.is_fm:
        enc = sk.encode if backend == "kernel" else secam.encode
    else:
        enc = qk.encode if backend == "kernel" else qam.encode
    comp = pipeline.encode_block(plan, rgb, gline, backend)
    assert torch.equal(comp, enc(plan, ycc, gline))
    if plan.cfg.is_fm:
        dec = pipeline._decode_fm(plan, comp, gline, decoder, pipeline.STAGES[backend])
    else:
        dec = pipeline._demodulate_qam(plan, comp, gline, decoder, pipeline.STAGES[backend])
        dec = pipeline._correct_chroma(plan, dec, gline, None, None)
    if decoder in pipeline.AVERAGING:
        # the delay line comes with the decoder's matrix, after the hooks
        y, c1, c2 = dec.unbind(-3)
        dec = torch.stack([y, average_with_neighbor(c1), average_with_neighbor(c2)], dim=-3)
    want = clamp01(_composition(plan.ycc_to_rgb, dec))
    assert torch.equal(pipeline.decode_block(plan, comp, gline, decoder, backend), want)


def test_kernel_source_sums_in_order_and_keeps_nans():
    """What the CPU can check of ``csrc/colour_matrix.cu``: each output a
    product then two float32 multiply-adds in the order c = 0, 1, 2, as the
    plain version; the clamp passing a NaN through; no shared memory (so
    no poison block for the sanitizer's build); built without fast math."""
    from color_modem_tpu_torch.kernels.build import CSRC_DIR, NVCC_FLAGS, SIGNATURES

    text = (CSRC_DIR / "colour_matrix.cu").read_text()
    for d in range(3):
        assert (f"y{d} = fmaf(x2, m.m[{3 * d + 2}], fmaf(x1, m.m[{3 * d + 1}], "
                f"__fmul_rn(x0, m.m[{3 * d}])));") in text
    assert "return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);" in text
    assert "__shared__" not in text and "CMT_POISON" not in text
    assert not any("fast_math" in f or "fmad=false" in f for f in NVCC_FLAGS)
    assert len(SIGNATURES["colour_matrix"]) == 7


# --- the delay line and the decoder's matrix in one pass (delayline_matrix) ------------

def _delayline_composition(mat, x):
    """The decoder's last steps as the pipeline composed them before the
    pass: ``average_with_neighbor`` on C1 and C2, the stack, the matrix and
    ``clamp01``."""
    y, c1, c2 = x.unbind(-3)
    ycc = torch.stack([y, average_with_neighbor(c1), average_with_neighbor(c2)], dim=-3)
    return clamp01(_composition(mat, ycc))


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("lines", [576, 63, 2])
def test_delayline_matrix_on_the_cpu_is_the_composition(lines, frames):
    """Bit for bit, NaNs and infinities included, at a full 576-line frame,
    an odd count and the least the delay line takes."""
    mat = plan_of("pal").ycc_to_rgb
    x = _wild(lines * frames, (frames, 3, lines, 24))
    got = ck.delayline_matrix(mat, x)
    assert torch.equal(bits(got), bits(_delayline_composition(mat, x)))
    assert torch.equal(bits(got), bits(delayline_mat3(mat, x)))
    assert torch.isnan(got).any() and not torch.isinf(got).any()


def test_delayline_matrix_reflects_line_0_onto_line_1():
    """Line 0 averages with line 1, every other line with the one before;
    a NaN in a chroma sample reaches its own line and the line after (and
    line 0, from line 1)."""
    mat = plan_of("pal").ycc_to_rgb
    x = torch.rand((2, 3, 5, 8), generator=torch.Generator().manual_seed(11))
    got = ck.delayline_matrix(mat, x)
    for line, nb in ((0, 1), (1, 0), (2, 1), (4, 3)):
        ycc = torch.stack([x[:, 0, line], 0.5 * (x[:, 1, line] + x[:, 1, nb]),
                           0.5 * (x[:, 2, line] + x[:, 2, nb])], dim=1)[:, :, None]
        assert torch.equal(got[:, :, line:line + 1], clamp01(_composition(mat, ycc)))
    x[1, 2, 1, 3] = float("nan")
    nan = torch.isnan(ck.delayline_matrix(mat, x))
    assert nan[1, :, :3, 3].all() and int(nan.sum()) == 9


def test_delayline_matrix_checks_its_inputs():
    mat = plan_of("pal").ycc_to_rgb
    x = torch.zeros((2, 3, 4, 8))
    with pytest.raises(TypeError):
        ck.delayline_matrix(mat, x.double())
    with pytest.raises(ValueError, match=r"\(\.\.\., 3, L, N\)"):
        ck.delayline_matrix(mat, torch.zeros((2, 4, 4, 8)))
    with pytest.raises(ValueError, match="mat"):
        ck.delayline_matrix(mat[:, :2], x)
    with pytest.raises(ValueError, match="2 or more lines"):
        ck.delayline_matrix(mat, torch.zeros((2, 3, 1, 8)))
    with pytest.raises(ValueError, match="device"):
        ck.delayline_matrix(mat, x.to("meta"))
    assert ck.delayline_matrix(mat, torch.zeros((0, 3, 4, 8))).shape == (0, 3, 4, 8)


def test_delayline_matrix_call_passes_groups_lines_and_samples():
    mat = plan_of("pal").ycc_to_rgb
    x = torch.zeros((2, 5, 3, 7, 9))
    out = torch.empty_like(x)
    tensors, scalars = ck.delayline_matrix_call(mat, x, out)
    assert tensors[0] is x and tensors[1] is mat and tensors[2] is out
    assert scalars == (10, 7, 9)


AVERAGING_BLOCKS = [("pal", "delayline"), ("ntsc", "avg"), ("pal60", "delayline"),
                    ("ntsc443", "avg"), ("niir", "avg")]


#: kernel against plain backend on the CPU: their QAM demodulations (the
#: kernels' plain versions and ``modem/qam.py``) sum in other orders and
#: differ by an ulp or two, the same on every decoder (comb3 reads 3e-7)
BACKENDS_ATOL = 1e-6


@pytest.mark.parametrize("name,decoder", AVERAGING_BLOCKS)
def test_averaging_decoders_agree_on_both_backends(name, decoder):
    """The kernel backend, which takes the one pass, gives bit for bit its
    own demodulation through the hooks, the averages, the matrix and the
    clamp as composed steps, and agrees with the plain backend: the round
    trip, and a decode with the burst phase and gain hooks."""
    plan = plan_of(name)
    rgb = torch.tensor(smooth_scene(12, N, seed=6), dtype=torch.float32)[None].repeat(3, 1, 1, 1)
    outs = {b: make_pipeline(plan, decoder, b, "cpu")[2](rgb, 7) for b in ("kernel", "plain")}
    assert float((outs["kernel"] - outs["plain"]).abs().max()) <= BACKENDS_ATOL
    gline = frame_line_index(plan, 7, 3, 12, "cpu")
    comp = pipeline.encode_block(plan, rgb, gline, "plain")
    phase = torch.linspace(-0.3, 0.3, 12).expand(3, 12)
    gain = torch.linspace(0.8, 1.2, 12).expand(3, 12)
    hooked = {b: pipeline.decode_block(plan, comp, gline, decoder, b, phase, gain)
              for b in ("kernel", "plain")}
    ycc = pipeline._demodulate_qam(plan, comp, gline, decoder, pipeline.STAGES["kernel"])
    ycc = pipeline._correct_chroma(plan, ycc, gline, phase, gain)
    assert torch.equal(bits(hooked["kernel"]), bits(_delayline_composition(plan.ycc_to_rgb, ycc)))
    assert float((hooked["kernel"] - hooked["plain"]).abs().max()) <= BACKENDS_ATOL
    nominal = pipeline.decode_block(plan, comp, gline, decoder, "kernel")
    assert not torch.equal(hooked["kernel"], nominal)


@pytest.mark.parametrize("name,decoder,takes_pass", [("pal", "delayline", True),
                                                     ("ntsc", "avg", True),
                                                     ("niir", "avg", True),
                                                     ("secam", "avg", True),
                                                     ("pal", "comb3", False),
                                                     ("niir", "notch", False),
                                                     ("secam", "interp", False)])
def test_which_decoders_take_the_delayline_step(name, decoder, takes_pass, monkeypatch):
    """Every averaging decoder ends in the delay line and matrix as one
    step, on either backend: the QAM decoders after the hooks (NIIR's after
    its normalisation), SECAM's on the assembled D'R/D'B planes.  The other
    decoders take the colour matrix."""
    seen = []

    def spy(backend, real):
        return lambda mat, x: seen.append(backend) or real(mat, x)

    for backend, stages in list(pipeline.STAGES.items()):
        monkeypatch.setitem(pipeline.STAGES, backend, stages._replace(
            delayline_matrix=spy(backend, stages.delayline_matrix)))
    rgb = torch.tensor(smooth_scene(8, N, seed=2), dtype=torch.float32)[None]
    for backend in ("plain", "kernel"):
        make_pipeline(plan_of(name), decoder, backend, "cpu")[2](rgb, 0)
    assert seen == (["plain", "kernel"] if takes_pass else [])


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_delayline_mat3_on_the_cpu_is_the_composition(backend):
    mat, x = plan_of("pal").ycc_to_rgb, _wild(9, (2, 3, 7, 33))
    assert torch.equal(bits(pipeline.STAGES[backend].delayline_matrix(mat, x)),
                       bits(_delayline_composition(mat, x)))
