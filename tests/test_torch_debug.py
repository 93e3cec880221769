"""The port's sanitizer (``utils/debug.py::checked``) against the JAX
package's (checkify's float checks) on the same functions and inputs.

Whether a call raises, and with which kind of error, must match:
checkify's ``NaNError`` is ``FloatingPointError`` here, its
``DivisionByZeroError`` is ``ZeroDivisionError``.  The JAX side runs with
``jax_debug_nans`` off (the test configuration turns it on), so that
checkify's own verdict is what is read.  The hook that hands the CUDA
kernels' outputs to the checks is driven here on CPU tensors.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (
    _get_current_dispatch_mode,
    _get_current_dispatch_mode_stack,
)

import jax
import jax.numpy as jnp

from torch_threads import one_torch_thread  # noqa: F401

from color_modem_tpu.frame.pipeline import frame_line_index as jax_line_index
from color_modem_tpu.frame.pipeline import make_pipeline as jax_make_pipeline
from color_modem_tpu.modem import qam as jax_qam
from color_modem_tpu.modem import secam as jax_secam
from color_modem_tpu.modem.plan import make_plan as jax_make_plan
from color_modem_tpu.standards import ALL_STANDARDS as JAX_STANDARDS
from color_modem_tpu.utils.debug import checked as jax_checked

from color_modem_tpu_torch import ALL_STANDARDS
from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
from color_modem_tpu_torch.kernels import qam as qk
from color_modem_tpu_torch.kernels import secam as sk
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.standards.decoders import allowed_decoders
from color_modem_tpu_torch.utils import debug
from color_modem_tpu_torch.utils.debug import checked
from color_modem_tpu_torch.utils.testimages import smooth_scene

L, N = 16, 720


def jax_verdict(fn, *args):
    """None, FloatingPointError or ZeroDivisionError: what JAX ``checked``
    says of ``fn(*args)``, in the port's terms."""
    with jax.debug_nans(False):
        try:
            jax.block_until_ready(jax_checked(fn)(*args))
        except Exception as e:  # checkify raises JaxRuntimeError
            msg = str(e)
            if "division by zero" in msg:
                return ZeroDivisionError
            if "nan generated" in msg:
                return FloatingPointError
            raise
    return None


def port_verdict(fn, *args):
    try:
        checked(fn)(*args)
    except (FloatingPointError, ZeroDivisionError) as e:
        assert _get_current_dispatch_mode() is None and _get_current_dispatch_mode_stack() == []
        return type(e)
    return None


def _rgb(seed: int = 0) -> np.ndarray:
    return smooth_scene(L, N, seed=seed)[None].astype(np.float32)


def _pipelines(name: str, decoder: str):
    return (jax_make_pipeline(jax_make_plan(JAX_STANDARDS[name](), N), decoder),
            make_pipeline(make_plan(ALL_STANDARDS[name](), N), decoder, device="cpu"))


@pytest.mark.parametrize("name", sorted(ALL_STANDARDS))
def test_clean_roundtrip_default_decoder(name):
    decoder = allowed_decoders(ALL_STANDARDS[name]())[0]
    (_, _, rt_j), (_, _, rt_t) = _pipelines(name, decoder)
    rgb = _rgb()
    assert jax_verdict(rt_j, jnp.asarray(rgb), 0) is None
    assert port_verdict(rt_t, torch.tensor(rgb), 0) is None
    out = checked(rt_t)(torch.tensor(rgb), 0)
    assert torch.equal(out, rt_t(torch.tensor(rgb), 0))


@pytest.mark.parametrize("name, decoder", [("ntsc", "comb3"), ("secam", "notch"),
                                           ("pal", "delayline")])
def test_nan_in_the_composite(name, decoder):
    (enc_j, dec_j, _), (enc_t, dec_t, _) = _pipelines(name, decoder)
    comp = np.asarray(enc_j(jnp.asarray(_rgb(1)), 0)).copy()
    comp[0, 5, 100] = np.nan
    want = jax_verdict(dec_j, jnp.asarray(comp), 0)
    assert want is FloatingPointError
    assert port_verdict(dec_t, torch.tensor(comp), 0) is want
    with pytest.raises(FloatingPointError, match=r"decode: output holds a NaN or an infinity; "
                                                 r"first aten\.\S+ made a NaN at "):
        checked(dec_t)(torch.tensor(comp), 0)


def _x():
    return np.linspace(0.0, 4.0, 33, dtype=np.float32)


def where_removed(lib):
    def fn(x):
        return lib.where(x > 2.0, lib.sqrt(x - 2.0), 0.0)
    return fn


def clamp_removed(lib):
    def fn(x):
        y = lib.sqrt(x - 2.0)
        y = lib.where(lib.isnan(y), -5.0, y)
        return lib.clip(y, 0.0, 1.0) if lib is jnp else lib.clamp(y, 0.0, 1.0)
    return fn


def masked_division(lib):
    def fn(x):
        d = x - 2.0
        return lib.where(d != 0.0, x / d, 0.0)
    return fn


def clean_division(lib):
    def fn(x):
        return x / (x + 1.0)
    return fn


@pytest.mark.parametrize("case", [where_removed, clamp_removed, masked_division,
                                  clean_division])
def test_made_and_removed_inside(case):
    x = _x()
    want = jax_verdict(case(jnp), jnp.asarray(x))
    assert port_verdict(case(torch), torch.tensor(x)) is want
    assert want is {where_removed: FloatingPointError, clamp_removed: FloatingPointError,
                    masked_division: ZeroDivisionError, clean_division: None}[case]


def test_made_and_removed_names_the_op_and_line():
    with pytest.raises(FloatingPointError,
                       match=r"fn: aten\.sqrt\.default made a NaN at .*test_torch_debug\.py:\d+"):
        checked(where_removed(torch))(torch.tensor(_x()))
    with pytest.raises(ZeroDivisionError, match=r"fn: aten\.div\.Tensor divides by zero"):
        checked(masked_division(torch))(torch.tensor(_x()))


def test_nan_made_inside_the_port_names_the_port_line():
    """A NaN made inside a port decode (one put into the plan's carrier
    ramp) is named at the line of ``color_modem_tpu_torch/`` that made it,
    beside the output that holds it."""
    (enc_j, _, _), _ = _pipelines("ntsc", "notch")
    comp = torch.tensor(np.asarray(enc_j(jnp.asarray(_rgb(2)), 0)))
    plan = make_plan(ALL_STANDARDS["ntsc"](), N)
    plan.ramp_cos[7] = float("nan")
    _, dec, _ = make_pipeline(plan, "notch", device="cpu")
    with pytest.raises(FloatingPointError, match=r"decode: output holds a NaN or an infinity; "
                                                 r"first aten\.\S+ made a NaN at "
                                                 r"color_modem_tpu_torch/\S+\.py:\d+"):
        checked(dec)(comp, 0)


def _ycc(name: str, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ycc = np.stack([rng.uniform(0.0, 1.0, (2, L, N)), rng.uniform(-0.5, 0.5, (2, L, N)),
                    rng.uniform(-0.5, 0.5, (2, L, N))], axis=1).astype(np.float32)
    return ycc


@pytest.mark.parametrize("name, kind", [("ntsc", "encode"), ("pal", "encode"),
                                        ("secam", "encode"), ("secam", "demodulate")])
@pytest.mark.parametrize("poison", [False, True])
def test_plain_kernel_versions(name, kind, poison):
    """The plain versions of the CUDA kernels (what a kernel wrapper runs on
    a CPU tensor) against the JAX package's plain twins, clean and with a
    NaN in one input sample."""
    jp, tp = jax_make_plan(JAX_STANDARDS[name](), N), make_plan(ALL_STANDARDS[name](), N)
    g_j, g_t = jax_line_index(jp, 3, 2, L), frame_line_index(tp, 3, 2, L, "cpu")
    x = _ycc(name)
    if kind == "demodulate":
        x = np.asarray(jax_secam.encode(jp, jnp.asarray(x), g_j))
    x = x.copy()
    if poison:
        x.reshape(-1)[1234] = np.nan
    if kind == "encode":
        jax_fn = partial_plan(jax_secam.encode if name == "secam" else jax_qam.encode, jp, g_j)
        port_fn = partial_plan(sk.encode if name == "secam" else qk.encode, tp, g_t)
    else:
        jax_fn = partial_plan(jax_secam.demodulate_lines, jp, g_j)
        port_fn = partial_plan(sk.demodulate, tp, g_t)
    want = jax_verdict(jax_fn, jnp.asarray(x))
    assert want is (FloatingPointError if poison else None)
    assert port_verdict(port_fn, torch.tensor(x)) is want


def partial_plan(fn, plan, gline):
    def run(x):
        return fn(plan, x, gline)
    return run


def test_kernel_hook_names_the_kernel():
    """A CUDA wrapper hands its outputs to ``note_kernel`` after the launch,
    which the dispatcher does not see; a NaN there is named as the
    kernel's, even where a later step removes it."""
    def kernel_only(x):
        out = x + 1.0
        with torch.utils._python_dispatch._disable_current_modes():
            out.view(-1)[2] = float("nan")  # a write the dispatcher does not see
        debug.note_kernel("secam_decode", out)
        return torch.nan_to_num(out)

    with pytest.raises(FloatingPointError, match=r"the CUDA kernel secam_decode made a NaN"):
        checked(kernel_only)(torch.ones(3, 4))
    debug.note_kernel("secam_decode", torch.tensor([float("nan")]))  # no check active


def test_no_mode_left_after_a_raise():
    for fn in (where_removed(torch), masked_division(torch)):
        with pytest.raises((FloatingPointError, ZeroDivisionError)):
            checked(fn)(torch.tensor(_x()))
        assert _get_current_dispatch_mode() is None
        assert _get_current_dispatch_mode_stack() == []

    def raises(x):
        raise KeyError("inside")

    with pytest.raises(KeyError):
        checked(raises)(torch.ones(2))
    assert _get_current_dispatch_mode() is None and _get_current_dispatch_mode_stack() == []


def test_nested_checks_both_see_the_kernel():
    def inner(x):
        out = x + 0.0
        with torch.utils._python_dispatch._disable_current_modes():
            out[0] = float("nan")
        debug.note_kernel("qam_encode", out)
        return torch.nan_to_num(out)

    def outer(x):
        try:
            checked(inner)(x)
        except FloatingPointError:
            pass
        return x * 1.0

    with pytest.raises(FloatingPointError, match="the CUDA kernel qam_encode"):
        checked(outer)(torch.ones(3))
