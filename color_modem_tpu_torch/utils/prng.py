"""JAX's threefry2x32 keys and samplers, so that the port draws the JAX
package's noise on every device.

The JAX package draws every noise from ``jax.random`` under its default
PRNG: threefry2x32 in its partitionable form (``jax_threefry_partitionable``
is on in the JAX this port follows), with 64-bit mode off.  This module
gives the same numbers from the same keys:

* a :class:`Key` is a frozen pair of Python ints, so :func:`PRNGKey`,
  :func:`fold_in` and :func:`split` run on the host, never touch a device
  and never synchronise one;
* :func:`random_bits`, :func:`uniform`, :func:`bernoulli` and
  :func:`randint` equal ``jax.random``'s bit for bit; :func:`normal` is
  ``sqrt(2) * erf_inv(u)`` with XLA's float32 ``erf_inv``, within an ulp
  or two of JAX (the ``log1p`` of each library);
* :func:`add_normal` is the noise sites' one call: ``x + sigma *
  normal(key_i, item shape)`` over a leading axis of items, ``key_i``
  the key itself or ``fold_in(key, g0 + i)``.

On a CPU tensor the plain versions here run: int64 tensors masked to 32
bits (PyTorch's CPU build has no uint32 add or shift).  On a CUDA tensor
the samplers launch ``csrc/threefry.cu`` through ``kernels/prng.py``,
which raises where it cannot launch.  Only float32 draws and int32
``randint`` exist: what the noise sites use.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

import color_modem_tpu_torch.dsp  # noqa: F401 - warms MKL's log1p and sqrt first

M32 = 0xFFFFFFFF
#: threefry2x32's key-schedule parity constant and its two rotation sets
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: ``normal``'s uniform draws lie in [nextafter(-1, 0), 1), as in JAX
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))
#: XLA's float32 erf_inv (M. Giles' polynomials), for w = -log1p(-x*x) < 5
#: (on w - 2.5) and otherwise (on sqrt(w) - 3), highest degree first, each
#: coefficient rounded to float32
ERFINV_SMALL = tuple(map(float, np.float32([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941])))
ERFINV_LARGE = tuple(map(float, np.float32([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682])))


class Key(NamedTuple):
    """A threefry2x32 key: ``jax.random.key_data`` of a JAX key, as two
    Python ints in [0, 2^32)."""

    k0: int
    k1: int


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of the counter pair ``(x0, x1)`` under the key
    ``(k0, k1)``: 20 rounds, a key injection after every four.  Each
    argument is a Python int or an int64 tensor of values in [0, 2^32)
    (broadcasting); so is each of the two words returned."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


# --- keys: host ints, no device ---------------------------------------------------------


def PRNGKey(seed: int) -> Key:  # noqa: N802 - JAX's name
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed taken
    mod 2^32 is the key's low word."""
    return Key(0, int(seed) & M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``, ``data`` taken mod 2^32: the hash
    of the counter ``(0, data)``."""
    return Key(*threefry2x32(key.k0, key.k1, 0, int(data) & M32))


def split(key: Key, num: int = 2) -> tuple[Key, ...]:
    """``jax.random.split(key, num)`` in the partitionable form: key ``i``
    is the hash of the counter ``(0, i)``, which is ``fold_in(key, i)``."""
    return tuple(fold_in(key, i) for i in range(num))


def as_key(key: Key | int) -> Key:
    """``key``, or ``PRNGKey(key)`` for an int (``frame/rf.py::rf_dropout``
    takes either, as its JAX twin does)."""
    return PRNGKey(key) if isinstance(key, int) else key


# --- the plain versions: int64 tensors masked to 32 bits ---------------------------------


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 of the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _counter_bits(k0, k1, i: torch.Tensor) -> torch.Tensor:
    """int64 ``bits1 ^ bits2`` of the flat counters ``i`` (int64), their
    high and low words the hash's counter pair."""
    b0, b1 = threefry2x32(k0, k1, i >> 32, i & M32)
    return b0 ^ b1


def random_bits_plain(key: Key, shape, device) -> torch.Tensor:
    """Plain version of :func:`random_bits`."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    return to_int32(_counter_bits(key.k0, key.k1, i)).reshape(tuple(shape))


def unit_float(bits: torch.Tensor) -> torch.Tensor:
    """JAX's ``uniform`` on [0, 1) from int32 bits: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1 (exact)."""
    return (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, operation for operation: ``w =
    -log1p(-x*x)``, then the polynomial of ``w - 2.5`` or of ``sqrt(w) -
    3`` by Horner, times ``x``.  For |x| < 1 (what :func:`normal` draws)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(small, a, b) for a, b in zip(ERFINV_SMALL, ERFINV_LARGE)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return p * x


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Unit normal float32 from int32 bits: the uniform on [NORMAL_LO, 1)
    (``f * 2 + lo``, clamped below at ``lo``; the scale ``1 - lo`` is 2.0
    in float32), then ``sqrt(2) * erf_inv``."""
    u = torch.clamp_min(unit_float(bits) * 2.0 + NORMAL_LO, NORMAL_LO)
    return SQRT2 * erf_inv(u)


def add_normal_plain(x: torch.Tensor | None, sigma: float, key: Key, shape, device,
                     g0: int | None = None) -> torch.Tensor:
    """Plain version of :func:`add_normal` (and, with ``x`` None, of
    :func:`normal`): ``x + float32(sigma) * normal`` over ``shape``, its
    leading axis the items when ``g0`` is given."""
    shape = tuple(shape)
    if g0 is None:
        bits = _counter_bits(key.k0, key.k1, torch.arange(math.prod(shape),
                                                          dtype=torch.int64, device=device))
    else:
        items = torch.arange(shape[0], dtype=torch.int64, device=device)
        f0, f1 = threefry2x32(key.k0, key.k1, 0, (g0 + items) & M32)
        i = torch.arange(math.prod(shape[1:]), dtype=torch.int64, device=device)
        bits = _counter_bits(f0[:, None], f1[:, None], i[None, :])
    n = normal_from_bits(to_int32(bits)).reshape(shape)
    return n if x is None else x + float(np.float32(sigma)) * n


# --- the samplers: the kernel on a CUDA device, the plain versions on the CPU ----------


def random_bits(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int32 of the same bits,
    on ``device``."""
    from color_modem_tpu_torch.kernels.prng import threefry_bits

    return threefry_bits(key, tuple(shape), torch.device(device))


def uniform(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 on [0, 1)."""
    return unit_float(random_bits(key, shape, device))


def bernoulli(key: Key, p: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode "low"): a float32
    uniform below ``p`` (as float32)."""
    return uniform(key, shape, device) < float(np.float32(p))


def randint(key: Key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)``, int32: two
    words from ``split(key)``, JAX's biased remainder in uint32
    arithmetic (``maxval <= minval`` gives ``minval``)."""
    lo32, hi32 = -(1 << 31), (1 << 31) - 1
    if not (lo32 <= minval <= hi32 and lo32 <= maxval <= hi32):
        raise ValueError(f"randint: bounds {minval}, {maxval} outside int32")
    k1, k2 = split(key)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = (mult * mult & M32) % span
    higher = random_bits(k1, shape, device).to(torch.int64) & M32
    lower = random_bits(k2, shape, device).to(torch.int64) & M32
    offset = (((higher % span) * mult + lower % span) & M32) % span
    return (minval + offset).to(torch.int32)


def normal(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape)``, float32."""
    from color_modem_tpu_torch.kernels.prng import threefry_add_normal

    return threefry_add_normal(None, 1.0, key, tuple(shape), torch.device(device))


def add_normal(x: torch.Tensor, sigma: float, key: Key,
               g0: int | None = None) -> torch.Tensor:
    """``x + float32(sigma) * normal`` in one pass.  With ``g0`` None the
    normal is ``normal(key, x.shape)``; with ``g0``, item ``i`` of ``x``'s
    leading axis draws ``normal(fold_in(key, g0 + i), x.shape[1:])`` (the
    runner's per-frame keying, ``g0 + i`` taken mod 2^32)."""
    from color_modem_tpu_torch.kernels.prng import threefry_add_normal

    return threefry_add_normal(x, sigma, key, tuple(x.shape), x.device, g0)
