"""The port's threefry2x32 (``color_modem_tpu_torch/utils/prng.py``) against
``jax.random`` on the CPU.

Keys, ``split``, ``fold_in``, the raw bits, ``uniform``, ``bernoulli`` and
``randint`` are held bit for bit.  ``normal`` is held to 1e-6 absolute: the
port's float32 ``erf_inv`` is XLA's polynomial operation for operation, and
only the ``log1p`` of the two libraries differs (by an ulp of its
argument, up to 3 ulps of the draw, about 7.2e-7 near |x| = 3).  The
plain versions run here; ``tests/test_torch_kernels_cuda.py`` holds
``csrc/threefry.cu`` against them on the card.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from color_modem_tpu_torch.kernels import launch_counts, reset_launches
from color_modem_tpu_torch.kernels import prng as prng_k
from color_modem_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
NORMAL_ATOL = 1e-6
PORT = pathlib.Path(prng.__file__).resolve().parent.parent


def jkey(key: jax.Array) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def test_threefry_partitionable_is_jax_default():
    """The port follows the partitionable form; a JAX whose default changes
    fails here by name."""
    assert jax.config.jax_threefry_partitionable is True
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", [0, 1, 7, 11, 99, 0x5A7, 2**31 - 1])
def test_prng_key(seed):
    assert prng.PRNGKey(seed) == jkey(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", [0, 3, 2**30, 2**32 - 1])
@pytest.mark.parametrize("seed", [0, 0x5A7])
def test_fold_in(seed, data):
    want = jkey(jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(data)))
    assert prng.fold_in(prng.PRNGKey(seed), data) == want


@pytest.mark.parametrize("seed, num", [(7, 2), (0, 2), (11, 5)])
def test_split(seed, num):
    want = [jkey(k) for k in jax.random.split(jax.random.PRNGKey(seed), num)]
    assert list(prng.split(prng.PRNGKey(seed), num)) == want
    assert prng.split(prng.PRNGKey(7)) == ((3625411723, 1954958720), (195045567, 4062205631))


#: (key maker, shape): the runner's keys and a 3-D shape
BIT_CASES = {
    "key0-1d": (lambda m: m.PRNGKey(0), (4099,)),
    "sat-fold-3d": (lambda m: m.fold_in(m.PRNGKey(0x5A7), 3), (3, 17, 41)),
    "gcr-2d": (lambda m: m.PRNGKey(1), (19, 720)),
    "fold-big-1d": (lambda m: m.fold_in(m.PRNGKey(11), 123456), (1 << 16,)),
}


@pytest.mark.parametrize("case", list(BIT_CASES))
def test_random_bits_and_uniform_bit_for_bit(case):
    make, shape = BIT_CASES[case]
    kj, kt = make(jax.random), make(prng)
    bits = prng.random_bits(kt, shape, CPU)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == shape
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  np.asarray(jax.random.bits(kj, shape)))
    u = prng.uniform(kt, shape, CPU)
    np.testing.assert_array_equal(u.numpy(), np.asarray(jax.random.uniform(kj, shape)))


@pytest.mark.parametrize("seed", [0, 1, 0x5A7])
def test_normal_within_1e6(seed):
    shape = (1 << 16,)
    got = prng.normal(prng.PRNGKey(seed), shape, CPU).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    # the bulk is the same float: the two log1p differ on a few per cent
    assert (got == want).mean() > 0.9


def test_add_normal_per_item_keys_match_the_jax_runner():
    """``add_normal(x, s, key, g0)`` is the JAX runner's ``x + s * vmap(normal(
    fold_in(key, g)))`` over g = g0, g0 + 1, ... (frame/video.py), with g0
    + i taken mod 2^32; without ``g0`` the whole shape draws from ``key``."""
    x = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(np.float32)
    sigma = 0.03
    for g0 in (0, 37, 2**32 - 2):
        g = (np.uint32(g0) + np.arange(3, dtype=np.uint32)).astype(np.int64)
        per = jnp.stack([jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0x5A7),
                                                               np.uint32(i)), (5, 64))
                         for i in g])
        want = np.asarray(jnp.asarray(x) + jnp.float32(sigma) * per)
        got = prng.add_normal(torch.from_numpy(x), sigma, prng.PRNGKey(0x5A7), g0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    whole = prng.add_normal(torch.from_numpy(x), sigma, prng.PRNGKey(1)).numpy()
    want = np.asarray(jnp.asarray(x) + sigma * jax.random.normal(jax.random.PRNGKey(1), x.shape))
    np.testing.assert_allclose(whole, want, rtol=0, atol=NORMAL_ATOL)


#: (b, l, n_rf, span): frame/rf.py::rf_dropout's draws at the CLI's NTSC RF
#: hop (1 x 480 lines, r = 4, a 10 us span) and at the tests' small shapes
DROPOUT_SHAPES = [(1, 480, 2880, 1231), (2, 32, 2880, 985), (3, 7, 64, 70)]


@pytest.mark.parametrize("b, l, n_rf, span", DROPOUT_SHAPES)
@pytest.mark.parametrize("seed, rate", [(7, 0.1), (3, 0.15), (0, 0.05)])
def test_bernoulli_and_randint_exactly(b, l, n_rf, span, seed, rate):
    k1j, k2j = jax.random.split(jax.random.PRNGKey(seed))
    k1, k2 = prng.split(prng.PRNGKey(seed))
    hit = prng.bernoulli(k1, rate, (b, l), CPU)
    assert hit.dtype == torch.bool
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jax.random.bernoulli(k1j, rate, (b, l))))
    hi = max(n_rf - span, 1)
    start = prng.randint(k2, (b, l), 0, hi, CPU)
    assert start.dtype == torch.int32
    np.testing.assert_array_equal(start.numpy(), np.asarray(jax.random.randint(k2j, (b, l), 0, hi)))


@pytest.mark.parametrize("lo, hi", [(-5, 70000), (10, 10), (-3, 2**30), (0, 1)])
def test_randint_spans(lo, hi):
    """Spans above 2^16 (JAX's multiplier wraps to 0 there), an empty span
    and a negative low bound."""
    kj = jax.random.PRNGKey(9)
    got = prng.randint(prng.PRNGKey(9), (4, 33), lo, hi, CPU).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.random.randint(kj, (4, 33), lo, hi)))


def test_cpu_wrappers_run_the_plain_versions():
    """On the CPU the wrappers are the plain versions and launch nothing;
    a device with neither raises."""
    reset_launches()
    key = prng.fold_in(prng.PRNGKey(0), 5)
    assert torch.equal(prng_k.threefry_bits(key, (3, 9), CPU),
                       prng.random_bits_plain(key, (3, 9), CPU))
    x = torch.ones(2, 8)
    assert torch.equal(prng_k.threefry_add_normal(x, 0.5, key, (2, 8), CPU, 4),
                       prng.add_normal_plain(x, 0.5, key, (2, 8), CPU, 4))
    assert set(launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="device"):
        prng_k.threefry_bits(key, (3,), torch.device("meta"))
    with pytest.raises(TypeError, match="float32"):
        prng.add_normal(x.double(), 0.5, key)
    with pytest.raises(ValueError, match="leading axis"):
        prng.add_normal(torch.ones(()), 0.5, key, 0)


def test_no_torch_generator_at_the_noise_sites():
    """Every noise of the frame layer and of the CLI is drawn from a JAX key:
    no module there constructs a ``torch.Generator``."""
    files = sorted((PORT / "frame").glob("*.py")) + [PORT / "cli.py"]
    for f in files:
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
                assert name != "Generator", f"{f.name}:{node.lineno} builds a torch.Generator"
                kw = {k.arg for k in node.keywords}
                assert "generator" not in kw, f"{f.name}:{node.lineno} passes a generator"


def test_chip_smoke_pins_jax_values():
    """The values chip_smoke.py holds the card to (the card's machine has no
    JAX) are ``jax.random``'s, each recomputed from the call it is filed
    under; the port's plain versions give them on the CPU."""
    import chip_smoke

    scope = {"jax": jax, "PRNGKey": jax.random.PRNGKey, "split": jax.random.split,
             "fold_in": jax.random.fold_in}
    for call, want in chip_smoke.JAX_PINNED.items():
        got = np.asarray(eval(call, scope))  # noqa: S307 - the literal calls above
        got = got.astype(np.int64) if got.dtype == bool else got
        assert got.tolist() == want, call
    assert chip_smoke.check_jax_pinned(CPU) <= NORMAL_ATOL
