"""The kernels' memory sanitizer (``kernels/sanitize.py``) on the CPU.

The CUDA kernels cannot run here, so these tests drive the guard plumbing
around the kernels' plain versions, with the C arguments the wrappers
assemble (``*_call``): a clean function passes every check, and a
deliberately faulty one (a write one element past or before its output, a
read one element before or past its input, an output sample left
unwritten, an input written) is caught.  The poisoned build's flags and
sources are checked as text; ``tests/test_torch_kernels_cuda.py`` runs the
sanitizer itself on the card.
"""

import re

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from color_modem_tpu_torch import ALL_STANDARDS
from color_modem_tpu_torch.kernels import build, sanitize
from color_modem_tpu_torch.kernels import qam as qk
from color_modem_tpu_torch.kernels import secam as sk
from color_modem_tpu_torch.modem.plan import make_plan

N = 720
GUARD = sanitize.GUARD_LINES * N


def _plain(kernel, plan, v):
    """The plain version of ``kernel`` on the guarded views ``v`` (in the
    order of its C arguments): (output positions, results)."""
    if kernel == "qam_encode":
        return [6], [qk.encode_lines_plain(plan, v[0], v[1])]
    if kernel == "qam_decode":
        return [8], [qk.decode_lines_plain(plan, v[0], v[1], v[2])]
    if kernel == "secam_encode":
        return [6], [sk.encode_lines_plain(plan, v[0], v[1])]
    return [11, 12], list(sk.demodulate_lines_plain(plan, v[0], v[1]))


_PLANS = {}


def _plan(std):
    if std not in _PLANS:
        _PLANS[std] = make_plan(ALL_STANDARDS[std](), N)
    return _PLANS[std]


def _case(row):
    _, kernel, std, decoder = row
    plan = _plan(std)
    (tensors, _), outs = sanitize.kernel_call(kernel, plan, 2, 17, decoder, seed=1)
    return kernel, plan, tensors, outs


def _launcher(kernel, plan, fault=None):
    def launch(views):
        pos, results = _plain(kernel, plan, views if fault != "read" else _shifted(views, kernel))
        for p, r in zip(pos, results):
            views[p].copy_(r)
        out = views[pos[0]]
        if fault == "write_past":
            torch.as_strided(out, (out.numel() + 1,), (1,), out.storage_offset())[-1] = 0.5
        elif fault == "write_before":
            torch.as_strided(out, (1,), (1,), out.storage_offset() - 1)[0] = 0.5
        elif fault == "unwritten":
            out.view(-1)[-1] = torch.tensor(sanitize.SENTINEL_BITS, dtype=torch.int32).view(
                torch.float32)
        elif fault == "input_written":
            views[0].view(-1)[3] += 1.0
    return launch


def _shifted(views, kernel):
    """The first input read one element early: its first sample comes from
    the guard band before it."""
    v = views[0]
    early = torch.as_strided(v, v.shape, v.stride(), v.storage_offset() - 1)
    return [early, *views[1:]]


@pytest.mark.parametrize("row", sanitize.ROWS, ids=lambda r: f"{r[0]}-{r[2]}")
def test_plain_versions_pass_the_guards(row):
    kernel, plan, tensors, outs = _case(row)
    pos = sanitize._order_outputs(tensors, outs)
    rep = sanitize.guarded_call(_launcher(kernel, plan), tensors, pos, GUARD)
    assert rep["nan"] == 0 and rep["sentinel_hits"] == 0
    assert rep["sentinels_intact"] and rep["inputs_intact"]
    _, want = _plain(kernel, plan, tensors)
    for got, ref in zip(rep["outputs"], want):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("row", [sanitize.ROWS[0], sanitize.ROWS[3], sanitize.ROWS[7]],
                         ids=lambda r: f"{r[0]}-{r[2]}")
@pytest.mark.parametrize("fault, caught", [
    ("write_past", lambda r: not r["sentinels_intact"]),
    ("write_before", lambda r: not r["sentinels_intact"]),
    ("read", lambda r: r["nan"] > 0),
    ("unwritten", lambda r: r["sentinel_hits"] == 1),
    ("input_written", lambda r: not r["inputs_intact"]),
])
def test_faults_are_caught(row, fault, caught):
    kernel, plan, tensors, outs = _case(row)
    pos = sanitize._order_outputs(tensors, outs)
    rep = sanitize.guarded_call(_launcher(kernel, plan, fault), tensors, pos, GUARD)
    assert caught(rep), rep


@pytest.mark.parametrize("row", [sanitize.ROWS[1], sanitize.ROWS[6]],
                         ids=lambda r: f"{r[0]}-{r[2]}")
def test_repeats_catch_a_launch_that_changes_its_result(row):
    """The same guarded buffers launched again and again: a clean function
    repeats itself bit for bit; one whose result moves between launches
    (as a race would) is counted."""
    kernel, plan, tensors, outs = _case(row)
    pos = sanitize._order_outputs(tensors, outs)
    clean = sanitize.guarded_call(_launcher(kernel, plan), tensors, pos, GUARD, repeats=4)
    assert clean["repeats_changed"] == 0 and clean["sentinels_intact"]
    calls = []

    def racy(views):
        _launcher(kernel, plan)(views)
        calls.append(1)
        if len(calls) == 3:
            views[pos[0]].view(-1)[7] += 1e-3

    rep = sanitize.guarded_call(racy, tensors, pos, GUARD, sanitize.SENTINEL_BITS_2, repeats=4)
    assert rep["repeats_changed"] == 1 and rep["sentinel_hits"] == 0


def test_read_one_past_the_input_is_caught():
    kernel, plan, tensors, outs = _case(sanitize.ROWS[6])
    pos = sanitize._order_outputs(tensors, outs)

    def late(views):
        v = views[0]
        views[pos[0]].copy_(sk.encode_lines_plain(
            plan, torch.as_strided(v, v.shape, v.stride(), v.storage_offset() + 1), views[1]))

    assert sanitize.guarded_call(late, tensors, pos, GUARD)["nan"] > 0


def test_guards_are_a_tile_of_lines_and_keep_alignment():
    t = torch.arange(12.0).reshape(3, 4)
    flat, view = sanitize._guarded(t, sanitize.GUARD_BITS, GUARD, copy=True)
    assert torch.equal(view, t) and flat.numel() == t.numel() + 2 * GUARD
    assert torch.isnan(flat[:GUARD]).all() and torch.isnan(flat[-GUARD:]).all()
    assert (view.data_ptr() - flat.data_ptr()) % 16 == 0
    assert sanitize.GUARD_LINES >= 16  # the kernels' tile of lines (bf::kRows)
    sentinel = torch.tensor(sanitize.SENTINEL_BITS, dtype=torch.int32).view(torch.float32)
    assert torch.isfinite(sentinel)


def test_sanitize_refuses_cpu_tensors():
    _, plan, tensors, outs = _case(sanitize.ROWS[0])
    with pytest.raises(ValueError, match="CUDA"):
        sanitize.sanitize("qam_encode", (tensors, ()), outs)


def test_poisoned_build_flags_and_names():
    assert build.POISON_FLAGS == ("-DCMT_POISON",)
    assert not any("CMT_POISON" in f for f in build.NVCC_FLAGS)
    files, digest = build._sources()
    _, poison_digest = build._sources(build.NVCC_FLAGS + build.POISON_FLAGS)
    assert digest == build._sources(build.NVCC_FLAGS)[1] != poison_digest


@pytest.mark.parametrize("source, static", [("qam_encode.cu", ()), ("qam_decode.cu", ()),
                                            ("secam_encode.cu", ()),
                                            ("secam_decode.cu", ("is_r",))])
def test_every_kernel_poisons_its_shared_memory_first(source, static):
    """Each kernel of the source (the SECAM sources hold a pipelined and a
    serial kernel) opens with a poison block over all of its dynamic shared
    memory (the planes, rings and staging rows) and its static arrays,
    before its first staging or barrier."""
    text = (build.CSRC_DIR / source).read_text()
    blocks = list(re.finditer(r"#ifdef CMT_POISON\n(.*?)#endif\n", text, re.S))
    kernels = [m.start() for m in re.finditer(r"__global__ void", text)]
    assert blocks, source
    assert len(blocks) == len(kernels)
    for kernel, block, after in zip(kernels, blocks, kernels[1:] + [len(text)]):
        body = block.group(1)
        assert "bf::poison_shared(smem4, bf::dynamic_smem_bytes());" in body
        assert body.rstrip().endswith("__syncthreads();")
        # inside its own kernel, right after the shared declarations: nothing
        # stages, copies, initialises a barrier or syncs between the
        # kernel's opening brace and the block
        assert kernel < block.start() < after
        head = text[text.index("{", kernel) + 1:block.start()]
        for k in ("stage(", "load(", "ap::init(", "cp_async", "__syncthreads(", "group_sync("):
            assert k not in head, (source, k)
    for name in static:
        assert any(f"bf::poison_shared({name}, sizeof({name}));" in b.group(1) for b in blocks)
    assert "%dynamic_smem_size" in (build.CSRC_DIR / "band_fir.cuh").read_text()


def _prng_plain(kernel, call, views):
    """The plain version of a threefry entry point, from its C arguments,
    into the guarded output view."""
    from color_modem_tpu_torch.utils import prng

    _, scalars = call
    out = views[-1]
    if kernel == "threefry_bits":
        k0, k1, _ = scalars
        out.copy_(prng.random_bits_plain(prng.Key(k0, k1), out.shape, out.device))
        return
    k0, k1, fold, g0, sigma, _, _ = scalars
    out.copy_(prng.add_normal_plain(views[0], sigma, prng.Key(k0, k1), out.shape, out.device,
                                    g0 if fold else None))


@pytest.mark.parametrize("row", sanitize.PRNG_ROWS)
def test_prng_rows_pass_the_guards(row):
    """The threefry rows' C arguments (``kernels/prng.py::bits_call`` and
    ``normal_call``, a null addend for the normal alone) through the guard
    plumbing around the plain versions; the bits' words are not counted as
    NaNs, and one written past the output is caught."""
    kernel, call, outs = sanitize.prng_call(row, 2, 17, N, torch.device("cpu"))
    tensors = call[0]
    assert (tensors[0] is None) == (row == "threefry_normal")
    pos = sanitize._order_outputs(tensors, outs)
    rep = sanitize.guarded_call(lambda v: _prng_plain(kernel, call, v), tensors, pos, GUARD)
    assert rep["nan"] == 0 and rep["sentinel_hits"] == 0
    assert rep["sentinels_intact"] and rep["inputs_intact"]

    def past(views):
        _prng_plain(kernel, call, views)
        out = views[-1]
        torch.as_strided(out, (out.numel() + 1,), (1,), out.storage_offset())[-1] = 0.5

    assert not sanitize.guarded_call(past, tensors, pos, GUARD)["sentinels_intact"]


def test_threefry_kernel_poisons_its_key_first():
    """The threefry kernel (one template for both entry points) opens with
    a poison block over its one shared array, the item's key that thread 0
    hashes, before that thread writes it: a block that read the key before
    the barrier would hash with the poison and differ from the normal
    build."""
    text = (build.CSRC_DIR / "threefry.cu").read_text()
    blocks = list(re.finditer(r"#ifdef CMT_POISON\n(.*?)#endif\n", text, re.S))
    kernels = [m.start() for m in re.finditer(r"__global__ void", text)]
    assert len(blocks) == len(kernels) == 1
    body = blocks[0].group(1)
    assert "bf::poison_shared(key_s, sizeof(key_s));" in body
    assert body.rstrip().endswith("__syncthreads();")
    head = text[text.index("{", kernels[0]) + 1:blocks[0].start()]
    assert head.strip() == "__shared__ uint32_t key_s[2];"
    assert text.index("key_s[0] = a;") > blocks[0].end()


@pytest.mark.parametrize("row", sanitize.COLOUR_ROWS)
def test_colour_rows_pass_the_guards(row):
    """The colour matrix's C arguments (``kernels/colorimetry.py::colour_matrix_call``,
    ``delayline_matrix_call``) through the guard plumbing around the plain
    version: groups of three planes of L x N samples, the matrix an input
    like the planes; a read one element before the planes (a NaN, which the
    clamp keeps) and a write past the output are caught."""
    from color_modem_tpu_torch.dsp.colorimetry import apply_mat3, delayline_mat3

    delay = row == "delayline_matrix"
    kernel, (tensors, scalars), outs = sanitize.colour_call(row, _plan("pal" if delay else "ntsc"),
                                                            2, 17)
    if delay:
        assert (kernel, scalars) == ("delayline_matrix", (2, 17, N))

        def version(mat, x):
            return delayline_mat3(mat, x)
    else:
        assert kernel == "colour_matrix"
        assert scalars == (2, 17 * N, int(row == "colour_matrix_clamp"))

        def version(mat, x):
            return apply_mat3(mat, x, bool(scalars[2]))
    pos = sanitize._order_outputs(tensors, outs)
    assert pos == [2]

    def plain(views, shift=0):
        x = views[0]
        x = torch.as_strided(x, x.shape, x.stride(), x.storage_offset() - shift)
        views[2].copy_(version(views[1], x))

    rep = sanitize.guarded_call(plain, tensors, pos, GUARD)
    assert rep["nan"] == 0 and rep["sentinel_hits"] == 0
    assert rep["sentinels_intact"] and rep["inputs_intact"]
    assert torch.equal(rep["outputs"][0], version(tensors[1], tensors[0]))
    assert sanitize.guarded_call(lambda v: plain(v, shift=1), tensors, pos, GUARD)["nan"] > 0

    def past(views):
        plain(views)
        out = views[2]
        torch.as_strided(out, (out.numel() + 1,), (1,), out.storage_offset())[-1] = 0.5

    assert not sanitize.guarded_call(past, tensors, pos, GUARD)["sentinels_intact"]


@pytest.mark.parametrize("row,std,decoder", sanitize.COMB_ROWS)
def test_comb_rows_pass_the_guards(row, std, decoder):
    """The comb stencil's C arguments (``kernels/comb.py::comb_stencil_call``)
    through the guard plumbing around the plain version: frames of L x N
    samples at the standard's spacing; a read one line before the frames
    (a NaN, which the stencil keeps) and a write past the output are
    caught."""
    from color_modem_tpu_torch.kernels import comb
    from color_modem_tpu_torch.separate.comb import line_stencil
    from color_modem_tpu_torch.standards.decoders import comb_spacing

    plan = _plan(std)
    p = comb_spacing(plan.cfg)
    kernel, (tensors, scalars), outs = sanitize.comb_call(plan, 2, 17, decoder)
    assert kernel == "comb_stencil" and scalars == (2, 17, N, p, comb.FORMS[decoder])
    pos = sanitize._order_outputs(tensors, outs)
    assert pos == [1]

    def plain(views, shift=0):
        x = views[0]
        x = torch.as_strided(x, x.shape, x.stride(), x.storage_offset() - shift)
        views[1].copy_(line_stencil(x, p, decoder))

    rep = sanitize.guarded_call(plain, tensors, pos, GUARD)
    assert rep["nan"] == 0 and rep["sentinel_hits"] == 0
    assert rep["sentinels_intact"] and rep["inputs_intact"]
    assert torch.equal(rep["outputs"][0], line_stencil(tensors[0], p, decoder))
    assert sanitize.guarded_call(lambda v: plain(v, shift=N), tensors, pos, GUARD)["nan"] > 0

    def past(views):
        plain(views)
        flat = views[1].reshape(-1)
        torch.as_strided(flat, (1,), (1,), flat.storage_offset() + flat.numel()).fill_(0.0)

    assert not sanitize.guarded_call(past, tensors, pos, GUARD)["sentinels_intact"]
