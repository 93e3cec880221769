"""The CUDA kernels' memory sanitizer: poisoned shared memory and
guard-banded launches.

The port's counterpart of the JAX package's Pallas ``interpret=True``,
which its ``utils/debug.py`` calls the kernel memory sanitizer (and of
``compute-sanitizer``, which the card's machine does not run).  A kernel
is launched from the same C arguments its wrapper assembles
(``kernels/qam.py::encode_call``/``decode_call``,
``kernels/secam.py::encode_call``/``demodulate_call``,
``kernels/prng.py::bits_call``/``normal_call``,
``kernels/colorimetry.py::colour_matrix_call``/``delayline_matrix_call``,
``kernels/comb.py::comb_stencil_call``),
with each tensor moved into the middle of a larger allocation:

* every input into a flat allocation filled with :data:`GUARD_BITS`, a NaN,
  at least one tile of lines (:data:`GUARD_LINES` x N samples) before and
  after it: a read outside the input brings a NaN into the output;
* every output into one filled with :data:`SENTINEL_BITS`, a finite value:
  a write outside the output changes a sentinel, an output sample the
  kernel never writes keeps one (the repeats fill with
  :data:`SENTINEL_BITS_2`, so that a sample the kernel did write, with the
  sentinel's value by chance, is not taken for an unwritten one).

It is launched once from the normal library and once from the poisoned one
(``kernels/build.py::load_library(poison=True)``: shared memory filled with
a NaN before the first staging), and the normal library again
:data:`REPEATS` times.  :func:`sanitize` requires the poisoned outputs
bit for bit equal to the normal ones, no NaN in any output, every sentinel
and every input untouched, every output sample written, and every repeat
bit for bit equal to the first launch (a race that changes a result shows
there).  :func:`guarded_call` is the guard plumbing alone: the tests run
it on the CPU around the kernels' plain versions.

It launches the C functions directly, so the wrappers' launch counts do
not move.
"""

from __future__ import annotations

import torch

#: a quiet NaN with a recognisable payload: the inputs' guard bands
GUARD_BITS = 0x7FC0DEAD
#: finite float32s (about 0.2132 and 0.3235): the outputs' allocations, in the
#: first launches and in the repeats
SENTINEL_BITS, SENTINEL_BITS_2 = 0x3E5A5A5A, 0x3EA5A5A5
#: lines of guard before and after each tensor: one tile of the kernels
GUARD_LINES = 16
#: launches of the normal build on one set of buffers, each compared with the first
REPEATS = 20


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _guarded(t: torch.Tensor, bits: int, guard: int, copy: bool):
    """(flat allocation, view of its middle shaped like ``t``): ``guard``
    elements filled with ``bits`` on each side, the middle a copy of ``t``
    (``copy``) or filled with ``bits`` too."""
    flat = torch.empty(2 * guard + t.numel(), dtype=t.dtype, device=t.device)
    _bits(flat).fill_(bits)
    view = flat[guard : guard + t.numel()].view(t.shape)
    if copy:
        view.copy_(t)
    return flat, view


def guarded_call(launch, tensors: list, outputs: list, guard: int,
                 sentinel: int = SENTINEL_BITS, repeats: int = 1) -> dict:
    """Run ``launch(views)`` on guarded copies of ``tensors``, ``repeats``
    times on the same buffers.

    ``tensors``: float32 or int32 tensors, in the order ``launch`` takes
    them, None for a null pointer (its view is None); ``outputs``: the
    positions among them that ``launch`` writes (their contents are not
    copied) and fills with ``sentinel``.  Returns
    ``{"outputs": [copies of the output views], "nan": NaNs in the float
    outputs,
    "sentinels_intact": no guard changed, "sentinel_hits": output samples
    holding the sentinel after the launches, "inputs_intact": every input and its guards
    unchanged, "repeats_changed": output samples that differed from the
    first launch's in any later one}``, all fetched in one go."""
    allocs, views = [], []
    for i, t in enumerate(tensors):
        if t is None:
            allocs.append(None)
            views.append(None)
            continue
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"tensor {i}: expected float32 or int32, got {t.dtype}")
        out = i in outputs
        flat, view = _guarded(t.contiguous(), sentinel if out else GUARD_BITS, guard,
                              copy=not out)
        allocs.append(flat)
        views.append(view)
    launch(views)
    first = [_bits(views[i]).clone() for i in sorted(outputs)]
    changed = [torch.zeros((), dtype=torch.int64, device=first[0].device)]
    for _ in range(repeats - 1):
        launch(views)
        changed += [(_bits(views[i]) != f).sum() for i, f in zip(sorted(outputs), first)]
    return _report(tensors, outputs, guard, allocs, views, sentinel, torch.stack(changed).sum())


def _report(tensors, outputs, guard, allocs, views, sentinel, changed) -> dict:
    """What :func:`guarded_call` returns, from the guarded buffers after a
    launch: one stacked fetch."""
    outs, ins = [], []
    for i, (t, flat, view) in enumerate(zip(tensors, allocs, views)):
        if t is None:
            continue
        bits = _bits(flat)
        if i in outputs:
            outs += [torch.isnan(view).sum(),
                     (bits[:guard] != sentinel).sum() + (bits[-guard:] != sentinel).sum(),
                     (_bits(view) == sentinel).sum()]
        else:
            moved = (bits[:guard] != GUARD_BITS).sum() + (bits[-guard:] != GUARD_BITS).sum()
            ins.append(moved + (_bits(view) != _bits(t.contiguous())).sum())
    got = torch.stack([changed.to(outs[0].device)] + outs + ins).tolist()
    changed, got = got[0], got[1:]
    nan, guards, hits = got[0 : len(outs) : 3], got[1 : len(outs) : 3], got[2 : len(outs) : 3]
    return {
        "outputs": [views[i].clone() for i in sorted(outputs)],
        "nan": int(sum(nan)),
        "sentinels_intact": not any(guards),
        "sentinel_hits": int(sum(hits)),
        "inputs_intact": not any(got[len(outs):]),
        "repeats_changed": int(changed),
    }


def _order_outputs(tensors: list, outputs: list) -> list:
    """Positions of ``outputs`` (tensors, by identity) among ``tensors``."""
    pos = [next(i for i, t in enumerate(tensors) if t is o) for o in outputs]
    return sorted(pos)


def sanitize(name: str, call: tuple, outputs: list) -> dict:
    """Sanitize one launch of the CUDA kernel ``name``.

    ``call``: its C arguments, ``(tensors, scalars)``, from the wrappers'
    ``*_call`` functions; ``outputs``: the tensors among them that it
    writes.  Returns the normal launch's report (:func:`guarded_call`) with
    ``unwritten`` (the output samples that hold the sentinel under both
    fills), ``max_poison_diff`` (largest |poisoned - normal| over the outputs, NaN
    where only one side is a NaN), ``poison_equal`` (bit for bit),
    ``poison`` (the poisoned launch's report without its outputs),
    ``repeats_equal`` and ``ok``."""
    from color_modem_tpu_torch.kernels.build import launch, load_library

    tensors, scalars = call
    pos = _order_outputs(tensors, outputs)
    first = next(t for t in tensors if t is not None)
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the sanitizer launches CUDA kernels; tensors on {dev}")
    guard = GUARD_LINES * first.shape[-1]

    def runner(lib):
        def run(views):
            launch(lib, name, dev,
                   [*(None if v is None else v.data_ptr() for v in views), *scalars])
        return run

    normal = guarded_call(runner(load_library()), tensors, pos, guard)
    poison = guarded_call(runner(load_library(poison=True)), tensors, pos, guard)
    equal = all(torch.equal(_bits(a), _bits(b))
                for a, b in zip(normal["outputs"], poison["outputs"]))
    diff = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in zip(normal["outputs"], poison["outputs"]))

    # the repeats: fresh buffers filled with the second sentinel
    again = guarded_call(runner(load_library()), tensors, pos, guard, SENTINEL_BITS_2, REPEATS)
    repeats_equal = again["repeats_changed"] == 0 and all(
        torch.equal(_bits(a), _bits(b)) for a, b in zip(normal["outputs"], again["outputs"]))
    # unwritten: the sentinel under both fills (one alone may be a value written)
    unwritten = int(sum(int(((_bits(a) == SENTINEL_BITS) & (_bits(b) == SENTINEL_BITS_2)).sum())
                        for a, b in zip(normal["outputs"], again["outputs"])))

    ok = (equal and normal["nan"] == 0 and poison["nan"] == 0 and normal["sentinels_intact"]
          and poison["sentinels_intact"] and again["sentinels_intact"]
          and unwritten == 0
          and normal["inputs_intact"] and poison["inputs_intact"] and again["inputs_intact"]
          and repeats_equal)
    return {**normal, "unwritten": unwritten, "max_poison_diff": diff, "poison_equal": equal,
            "poison": {k: v for k, v in poison.items() if k != "outputs"},
            "repeats_equal": repeats_equal, "ok": ok}


# --- the kernels at the main path's inputs ------------------------------------------

#: (table row, CUDA kernel, standard, decoder whose stencil feeds the decode):
#: the unshared pair on NTSC, the shared pair on PAL (V-switch) and NIIR
#: (reference lines), and the SECAM pair
ROWS = (
    ("qam_encode", "qam_encode", "ntsc", None),
    ("qam_decode", "qam_decode", "ntsc", "comb3"),
    ("qam_encode_shared", "qam_encode", "pal", None),
    ("qam_decode_shared", "qam_decode", "pal", "delayline"),
    ("qam_encode_shared", "qam_encode", "niir", None),
    ("qam_decode_shared", "qam_decode", "niir", "avg"),
    ("secam_encode", "secam_encode", "secam", None),
    ("secam_decode", "secam_decode", "secam", "interp"),
)
#: lines per frame (ragged last tiles of 16 lines), samples per line, frames
LINES = (1, 63, 65, 481)
SAMPLES = (720, 722, 1440, 2160)
FRAMES = (1, 3)
#: samples at which only the SECAM rows run: the decoder's spans
SECAM_ONLY_SAMPLES = (2160,)
#: the threefry generator's rows (``csrc/threefry.cu``), on the QAM rows'
#: grid: the runner's noise (item keys folded in the kernel, from index 37),
#: one key over the block, the normal alone (no addend) and the raw bits
PRNG_ROWS = ("threefry_add_normal", "threefry_add_normal_one_key", "threefry_normal",
             "threefry_bits")
#: the colour matrix's rows (``csrc/colour_matrix.cu``), on the QAM rows'
#: grid: the encoder's RGB -> YIQ, the decoder's YIQ -> RGB with its clamp, and
#: the delay-line decoders' pass (PAL's YUV averaged with the line before, then
#: its matrix and clamp; not at one line, which it refuses)
COLOUR_ROWS = ("colour_matrix", "colour_matrix_clamp", "delayline_matrix")
#: the comb stencil's rows (``csrc/comb_stencil.cu``), on the QAM rows' grid:
#: (table row, standard, decoder), each form at NTSC's spacing (1 line) and
#: PAL's (2 lines); not below p + 1 lines, which it refuses
COMB_ROWS = (("comb_stencil_comb2", "ntsc", "comb2"), ("comb_stencil_comb3", "ntsc", "comb3"),
             ("comb_stencil_comb2_pal", "pal", "comb2"), ("comb_stencil_comb3_pal", "pal", "comb3"))


def kernel_call(kernel: str, plan, frames: int, lines: int, decoder, seed: int = 0):
    """(call, outputs) of one launch of ``kernel`` on seeded inputs of
    ``frames`` x ``lines`` x ``plan.n_samples`` on the plan's device: the
    components uniform in their ranges, a decode's composite the plain
    encode of them."""
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.kernels import qam, secam
    from color_modem_tpu_torch.separate.comb import stencil_signal

    dev, n = plan.rgb_to_ycc.device, plan.n_samples
    gen = torch.Generator(device=dev).manual_seed(seed)
    ycc = torch.rand((frames, 3, lines, n), generator=gen, device=dev)
    ycc[:, 1:] = 1.2 * ycc[:, 1:] - 0.6
    gline = frame_line_index(plan, 12345, frames, lines, dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    if kernel.startswith("qam"):
        cols = qam.phase_cols(plan, gline)
        if kernel == "qam_encode":
            out = empty(frames, lines, n)
            return qam.encode_call(plan, ycc, cols, out), [out]
        comp = qam.encode_lines_plain(plan, ycc, cols).contiguous()
        # a comb needs a line beside the line: one line takes the notch's
        # signal, the composite itself
        sep = (stencil_signal(plan, comp, decoder) if lines > 1 else comp).contiguous()
        out = empty(frames, 3, lines, n)
        return qam.decode_call(plan, sep, comp, cols, out), [out]
    isr = secam.isr_col(gline)
    if kernel == "secam_encode":
        out = empty(frames, lines, n)
        return secam.encode_call(plan, ycc, isr, out), [out]
    comp = secam.encode_lines_plain(plan, ycc, isr).contiguous()
    luma, v = empty(frames, lines, n), empty(frames, lines, n)
    return secam.demodulate_call(plan, comp, isr, luma, v), [luma, v]


def prng_call(row: str, frames: int, lines: int, n: int, dev, seed: int = 0):
    """(C entry point, call, outputs) of one threefry launch of
    :data:`PRNG_ROWS` over ``frames`` x ``lines`` x ``n`` on ``dev``: the
    addend uniform, the bits int32 words."""
    from color_modem_tpu_torch.kernels import prng as pk
    from color_modem_tpu_torch.utils.prng import PRNGKey

    shape, key = (frames, lines, n), PRNGKey(0x5A7)
    if row == "threefry_bits":
        out = torch.empty(shape, dtype=torch.int32, device=dev)
        return row, pk.bits_call(key, out), [out]
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = None if row == "threefry_normal" else torch.rand(shape, generator=gen, device=dev)
    g0 = 37 if row == "threefry_add_normal" else None
    return "threefry_add_normal", pk.normal_call(x, 0.05, key, g0, out), [out]


def colour_call(row: str, plan, frames: int, lines: int, seed: int = 0):
    """(C entry point, call, outputs) of one launch of :data:`COLOUR_ROWS`
    over ``frames`` x 3 x ``lines`` x ``plan.n_samples`` on the plan's
    device: RGB uniform in [0, 1] for the encoder's matrix, the components
    in their ranges for the decoder's and the delay line's."""
    from color_modem_tpu_torch.kernels import colorimetry

    dev, n = plan.rgb_to_ycc.device, plan.n_samples
    decoder = row != "colour_matrix"
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((frames, 3, lines, n), generator=gen, device=dev)
    if decoder:
        x[:, 1:] = 1.2 * x[:, 1:] - 0.6
    out = torch.empty_like(x)
    if row == "delayline_matrix":
        return row, colorimetry.delayline_matrix_call(plan.ycc_to_rgb, x, out), [out]
    mat = plan.ycc_to_rgb if decoder else plan.rgb_to_ycc
    return "colour_matrix", colorimetry.colour_matrix_call(mat, x, out, decoder), [out]


def comb_call(plan, frames: int, lines: int, decoder: str, seed: int = 0):
    """(C entry point, call, outputs) of one launch of the comb stencil over
    ``frames`` x ``lines`` x ``plan.n_samples`` on the plan's device at the
    plan's comb spacing: the composite uniform in [-0.5, 1.5]."""
    from color_modem_tpu_torch.kernels import comb
    from color_modem_tpu_torch.standards.decoders import comb_spacing

    dev = plan.rgb_to_ycc.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 2.0 * torch.rand((frames, lines, plan.n_samples), generator=gen, device=dev) - 0.5
    out = torch.empty_like(x)
    return "comb_stencil", comb.comb_stencil_call(x, out, comb_spacing(plan.cfg), decoder), [out]


def run_all(dev, lines=LINES, samples=SAMPLES, frames=FRAMES, report=None) -> list[dict]:
    """:func:`sanitize` every row of :data:`ROWS` at every (lines, samples,
    frames) on ``dev``, the QAM rows but at :data:`SECAM_ONLY_SAMPLES`, and
    every row of :data:`PRNG_ROWS`, :data:`COLOUR_ROWS` (on the NTSC
    plan's matrices, the delay line on PAL's) and :data:`COMB_ROWS` where
    the QAM rows run, the delay line but at one line and the comb below
    its spacing + 1 lines; ``report(result)`` after each.
    Returns the results, each with ``row``, ``kernel``, ``standard`` and
    ``shape``."""
    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.modem.plan import make_plan, plan_on
    from color_modem_tpu_torch.standards.decoders import comb_spacing

    plans, results = {}, []

    def run(row, kernel, std, shape, call, outs):
        res = sanitize(kernel, call, outs)
        del res["outputs"]
        res.update(row=row, kernel=kernel, standard=std, shape=shape)
        results.append(res)
        if report is not None:
            report(res)

    grid = [(f, l) for f in frames for l in lines]
    for n in samples:
        for row, kernel, std, decoder in ROWS:
            if n in SECAM_ONLY_SAMPLES and std != "secam":
                continue
            if (std, n) not in plans:
                plans[std, n] = plan_on(make_plan(ALL_STANDARDS[std](), n), dev)
            for f, l in grid:
                run(row, kernel, std, (f, l, n), *kernel_call(kernel, plans[std, n], f, l,
                                                              decoder))
        if n in SECAM_ONLY_SAMPLES:
            continue
        for row in PRNG_ROWS:
            for f, l in grid:
                kernel, call, outs = prng_call(row, f, l, n, dev)
                run(row, kernel, "threefry", (f, l, n), call, outs)
        for row in COLOUR_ROWS:
            std = "pal" if row == "delayline_matrix" else "ntsc"
            for f, l in grid:
                if row == "delayline_matrix" and l < 2:
                    continue
                kernel, call, outs = colour_call(row, plans[std, n], f, l)
                run(row, kernel, std, (f, l, n), call, outs)
        for row, std, decoder in COMB_ROWS:
            for f, l in grid:
                if l < comb_spacing(plans[std, n].cfg) + 1:
                    continue
                kernel, call, outs = comb_call(plans[std, n], f, l, decoder)
                run(row, kernel, std, (f, l, n), call, outs)
    return results
