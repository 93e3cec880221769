"""Three faults of the port against the reference, each pinned on the CPU.

* Precision: the JAX package pins each float32 product's precision on the
  call (``Precision.HIGH``/``HIGHEST``); the port must not let a
  process-wide setting (``torch.set_float32_matmul_precision``,
  ``torch.backends.cuda.matmul.allow_tf32``) change what an entry point
  computes.  A round trip under "medium" (bf16 products on this CPU) or
  with TF32 allowed is bit-identical to one under "highest", and the
  caller's setting is back afterwards.
* Resume across devices: the port once drew its noise from
  ``torch.Generator``s (Philox on the card, mt19937 on the CPU), other
  numbers on each device, and named the device type in a noisy manifest.
  It now draws the JAX package's threefry2x32 noise on every device
  (``utils/prng.py``): a noisy manifest records JAX's ``"abs-frame"``, a
  run resumes it on either device, and a manifest of another keying (the
  old per-device one) refuses.
* Shared plans: a factory works on a copy of the plan on its own device and
  never moves the caller's plan (``plan.to`` is in place), so any number of
  pipelines on any devices share one plan, as they share a JAX
  ``ModemPlan``.
"""

import json
import os
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from color_modem_tpu_torch import NTSC, PAL, SECAM
from color_modem_tpu_torch.dsp.apply import full_float32, matmul_f32
from color_modem_tpu_torch.frame.interlace import make_interlaced_pipeline
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.frame.svideo import make_svideo_pipeline
from color_modem_tpu_torch.frame.transcode import make_transcoder
from color_modem_tpu_torch.frame.video import NOISE_KEYING, process_video
from color_modem_tpu_torch.modem.plan import make_plan, plan_on
from color_modem_tpu_torch.utils.testimages import smooth_scene
from torch_threads import one_torch_thread  # noqa: F401

N = 720
_PLANS = {}


def _plan(cfg):
    if cfg.name not in _PLANS:
        _PLANS[cfg.name] = make_plan(cfg, N)
    return _PLANS[cfg.name]


def _fp32_flags():
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.mkldnn.matmul.fp32_precision)


@contextmanager
def _precision_restored():
    """Put every process-wide matmul precision setting back on the way out:
    the legacy one (``torch.get_float32_matmul_precision``, which
    ``set_float32_matmul_precision`` changes beside the per-backend flags)
    and the flags themselves."""
    legacy, flags = torch.get_float32_matmul_precision(), _fp32_flags()
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(legacy)
        torch.backends.cuda.matmul.fp32_precision, torch.backends.mkldnn.matmul.fp32_precision = \
            flags


@pytest.fixture
def restore_precision():
    """Put the process-wide matmul precision back after the test."""
    with _precision_restored():
        yield


def test_precision_settings_leave_no_trace():
    """A test that sets "medium" (bf16 products on this CPU) or allows TF32
    leaves every setting as it found it, the legacy getter included: the
    fixture once restored only the per-backend flags, and the legacy
    precision read "medium" for every later test in the worker."""
    before = (torch.get_float32_matmul_precision(), _fp32_flags(),
              torch.backends.cuda.matmul.allow_tf32)
    with _precision_restored():
        torch.set_float32_matmul_precision("medium")
        torch.backends.cuda.matmul.allow_tf32 = True
    assert (torch.get_float32_matmul_precision(), _fp32_flags(),
            torch.backends.cuda.matmul.allow_tf32) == before


@pytest.mark.parametrize("setting", ["medium", "allow_tf32"])
@pytest.mark.parametrize("cfg,decoder,lines", [(NTSC(), "comb3", 24), (PAL(), "delayline", 24),
                                               (SECAM(), "interp", 24)])
def test_round_trip_ignores_the_global_matmul_precision(restore_precision, cfg, decoder,
                                                        lines, setting):
    plan = _plan(cfg)
    rgb = torch.tensor(np.broadcast_to(smooth_scene(lines, N, seed=0), (2, 3, lines, N)),
                       dtype=torch.float32)
    _, _, rt = make_pipeline(plan, decoder, "kernel", "cpu")
    torch.set_float32_matmul_precision("highest")
    ref = rt(rgb)
    if setting == "medium":
        torch.set_float32_matmul_precision("medium")
    else:
        torch.backends.cuda.matmul.allow_tf32 = True
    before = _fp32_flags()
    got = rt(rgb)
    assert _fp32_flags() == before
    if setting == "medium":
        assert torch.get_float32_matmul_precision() == "medium"
    else:
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.equal(got, ref)


def test_full_float32_pins_and_restores(restore_precision):
    """Inside the guard a product is the full float32 one; outside, the
    caller's "medium" is in force again (here bf16 products, which differ)."""
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.normal(size=(64, 96)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(96, 80)), dtype=torch.float32)
    torch.set_float32_matmul_precision("highest")
    exact = a @ b
    torch.set_float32_matmul_precision("medium")
    with full_float32():
        assert _fp32_flags() == ("ieee", "ieee")
        assert torch.equal(a @ b, exact)
    assert torch.get_float32_matmul_precision() == "medium"
    assert torch.equal(matmul_f32(a, b), exact)
    assert _fp32_flags() == ("tf32", "bf16")
    with pytest.raises(RuntimeError, match="boom"), full_float32():
        raise RuntimeError("boom")
    assert _fp32_flags() == ("tf32", "bf16")


def _noisy_run(d, **kw):
    one = smooth_scene(16, N, seed=1).astype(np.float32)
    src = lambda start, count: np.broadcast_to(one, (count,) + one.shape)  # noqa: E731
    return process_video(_plan(NTSC()), src, 2, d, decoder="notch", chunk=1,
                         channel={"noise_sigma": 0.02}, device="cpu", **kw)


def test_noisy_manifest_names_the_device(tmp_path):
    """The keying a noisy manifest records is JAX's, whatever the device."""
    d = str(tmp_path / "run")
    s = _noisy_run(d)
    assert s["noise_keying"] == NOISE_KEYING == "abs-frame"
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["config"]["noise_keying"] == "abs-frame"
    # the same run resumes
    assert _noisy_run(d)["frames_processed_this_run"] == 0


def test_manifest_of_the_other_device_is_refused(tmp_path):
    """A noisy manifest written under the port's old per-device keying does
    not resume (the card test resumes a CPU-written one on the card)."""
    d = str(tmp_path / "run")
    _noisy_run(d)
    path = os.path.join(d, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    m["config"]["noise_keying"] = "abs-frame-torch-cuda"
    with open(path, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="refusing to resume"):
        _noisy_run(d)


_FACTORIES = {
    "pipeline": lambda p: make_pipeline(p, "comb3", "plain", "meta"),
    "interlaced": lambda p: make_interlaced_pipeline(p, "comb3", "plain", "meta"),
    "svideo": lambda p: make_svideo_pipeline(p, "plain", "meta"),
    "transcoder": lambda p: make_transcoder(p, _plan(PAL()), None, "plain", "meta"),
}


@pytest.mark.parametrize("factory", sorted(_FACTORIES))
def test_factory_leaves_the_callers_plan(factory):
    """A factory on another device ("meta" here, the card on a GPU machine)
    leaves the caller's CPU plan, and its every buffer, on the CPU."""
    plan = make_plan(NTSC(), N)
    _FACTORIES[factory](plan)
    assert {b.device.type for b in plan.buffers()} == {"cpu"}
    assert plan.c1_lpf.device.type == "cpu"
    pal = _plan(PAL())
    assert {b.device.type for b in pal.buffers()} == {"cpu"}


def test_plan_copies_are_made_once_per_device():
    plan = make_plan(SECAM(), N)
    assert plan_on(plan, "cpu") is plan
    meta = plan_on(plan, "meta")
    assert meta is not plan and meta is plan_on(plan, torch.device("meta"))
    assert {b.device.type for b in meta.buffers()} == {"meta"}
    assert {b.device.type for b in plan.buffers()} == {"cpu"}
    assert sorted(dict(meta.named_buffers())) == sorted(dict(plan.named_buffers()))
    assert meta.cfg is plan.cfg and meta.n_samples == plan.n_samples
    # a CPU pipeline built after a copy elsewhere still runs on the plan
    _, _, rt = make_pipeline(plan, "interp", "kernel", "cpu")
    rgb = torch.tensor(np.broadcast_to(smooth_scene(8, N, seed=0), (1, 3, 8, N)),
                       dtype=torch.float32)
    assert torch.isfinite(rt(rgb)).all()


def _top_level_imports(path) -> set:
    """The modules a module's body imports at import time (not in a def)."""
    import ast

    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, ast.Import):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names.add(node.module)
                names.update(f"{node.module}.{a.name}" for a in node.names)
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                visit(node.body)
                visit(getattr(node, "orelse", []))
                for h in getattr(node, "handlers", []):
                    visit(h.body)

    visit(ast.parse(path.read_text()).body)
    return names


def test_every_module_that_calls_mkl_math_warms_it_first():
    """PyTorch's MKL-backed CPU functions (``dsp._VML_FUNCTIONS``) have each
    run once on one element before any module of the port can call them on
    a large tensor: every module that calls one imports
    ``color_modem_tpu_torch.dsp``, directly or through its imports."""
    import pathlib
    import re

    from color_modem_tpu_torch import dsp

    root = pathlib.Path(dsp.__file__).resolve().parents[1]
    mods = {".".join(p.relative_to(root.parent).with_suffix("").parts).removesuffix(
        ".__init__"): p for p in root.rglob("*.py")}
    graph = {m: {n for n in _top_level_imports(p) if n in mods} for m, p in mods.items()}
    for m in mods:  # importing a.b.c runs a and a.b first
        parts = m.split(".")
        graph[m] |= {".".join(parts[:k]) for k in range(1, len(parts))}

    def reaches(m, seen):
        if m == "color_modem_tpu_torch.dsp":
            return True
        seen.add(m)
        return any(reaches(n, seen) for n in graph[m] - seen)

    calls = re.compile(r"torch\.(%s)\(" % "|".join(dsp._VML_FUNCTIONS))
    users = [m for m, p in mods.items() if calls.search(p.read_text())]
    assert len(users) > 10
    missing = [m for m in users if not reaches(m, set())]
    assert not missing, missing
    for name in dsp._VML_FUNCTIONS:
        assert callable(getattr(torch, name)), name
