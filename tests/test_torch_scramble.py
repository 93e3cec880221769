"""The PyTorch port's pay-TV scrambling (``frame/scramble.py``) against
``color_modem_tpu/frame/scramble.py`` on the CPU.

Everything here is integer arithmetic or a gather, so every comparison is
exact (``torch.equal``): the keyed hash (the JAX package's uint32 law,
carried in int64) over line indices up to 2^31 - 1 and keys past 32 bits,
the cut points, delays and shuffle permutations, the scrambled blocks in
all three modes with and without ``active_start``, and the descrambled
block against the original.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import get_plan
from color_modem_tpu.frame import scramble as js
from color_modem_tpu.frame.raster import make_raster as jax_make_raster
from color_modem_tpu_torch.frame import scramble as ts
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

KEYS = (0, 1, 0x5EC4E7, 0xC0FFEE, 2**32 - 1, 2**32 + 5, 12345678901)


def _lines():
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.arange(0, 4096), rng.integers(0, 2**31, 8192),
        [2**16 - 1, 2**16, 2**24, 2**31 - 2, 2**31 - 1],
    ]).astype(np.int32)


@pytest.mark.parametrize("key", KEYS)
def test_hash_matches_jax_up_to_2_pow_31(key):
    g = _lines()
    want = torch.tensor(np.asarray(js._hash32(jnp.asarray(g), key)).astype(np.int64))
    got = ts._hash32(torch.tensor(g), key)
    assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) < 2**32
    assert torch.equal(got, want)


def test_mul32_keeps_the_low_32_bits():
    rng = np.random.default_rng(1)
    h = np.concatenate([rng.integers(0, 2**32, 4096), [0, 1, 2**32 - 1, 2**31]])
    for c in (2654435761, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF, 3):
        want = [(int(v) * c) % 2**32 for v in h]
        assert ts._mul32(torch.tensor(h), c).tolist() == want


@pytest.mark.parametrize("name", ["ntsc", "pal"])
def test_key_schedules_match_jax(name):
    jp = get_plan(name)
    tp = plan_from_numpy(jp)
    g = (np.arange(3)[:, None] * jp.cfg.total_lines + 1000 + np.arange(64)[None, :]
         ).astype(np.int32)
    gj, gt = jnp.asarray(g), torch.tensor(g)
    for key in KEYS:
        cut = ts._cut_points(tp, gt, key)
        assert torch.equal(cut, torch.tensor(np.asarray(js._cut_points(jp, gj, key))
                                             .astype(np.int64)))
        n = jp.n_samples
        assert int(cut.min()) >= n // 8 and int(cut.max()) < n // 8 + 3 * n // 4
        assert torch.equal(ts._delay_samples(tp, gt, key),
                           torch.tensor(np.asarray(js._delay_samples(jp, gj, key))
                                        .astype(np.int64)))
        perm = ts._shuffle_perm(gt, key)
        assert torch.equal(perm, torch.tensor(np.asarray(js._shuffle_perm(gj, key))
                                              .astype(np.int64)))
        assert torch.equal(ts._invert_perm(perm), torch.tensor(
            np.asarray(js._invert_perm(jnp.asarray(perm.numpy()))).astype(np.int64)))
        # a permutation within each 32-line window
        windows = perm.reshape(3, 2, 32) - torch.arange(0, 64, 32)[:, None]
        assert torch.equal(windows.sort(-1).values, torch.arange(32).expand(3, 2, 32))


def test_rotation_is_a_floor_modulo():
    x = torch.arange(4 * 10, dtype=torch.float32).reshape(4, 10)
    shift = torch.tensor([-13, -1, 0, 27])
    got = ts._rotate_lines(x, shift)
    want = np.stack([np.roll(x[i].numpy(), -int(s)) for i, s in enumerate(shift)])
    assert torch.equal(got, torch.tensor(want))


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("mode", ts.MODES)
def test_scramble_matches_jax_and_inverts_exactly(mode, active):
    jp = get_plan("pal")
    tp = plan_from_numpy(jp)
    n_blank = jax_make_raster(jp).n_blank if active else 0
    rng = np.random.default_rng(2)
    comp = rng.normal(size=(2, 64, jp.n_samples + n_blank)).astype(np.float32)
    g = (np.arange(2)[:, None] * 625 + 12345 + np.arange(64)[None, :]).astype(np.int32)
    for key in KEYS[:4]:
        want = np.asarray(js.scramble(jp, jnp.asarray(comp), jnp.asarray(g), mode, key, n_blank))
        got = ts.scramble(tp, torch.tensor(comp), torch.tensor(g), mode, key, n_blank)
        assert torch.equal(got, torch.tensor(want))
        assert not torch.equal(got, torch.tensor(comp))
        if active:  # sync and burst stay in the clear
            assert torch.equal(got[..., :n_blank], torch.tensor(comp)[..., :n_blank])
        back = ts.descramble(tp, got, torch.tensor(g), mode, key, n_blank)
        assert torch.equal(back, torch.tensor(comp))
        want_back = js.descramble(jp, jnp.asarray(want), jnp.asarray(g), mode, key, n_blank)
        assert torch.equal(back, torch.tensor(np.asarray(want_back)))


def test_wrong_key_does_not_descramble():
    tp = plan_from_numpy(get_plan("ntsc"))
    comp = torch.rand(1, 32, 720)
    g = torch.arange(32, dtype=torch.int32)[None]
    scr = ts.scramble(tp, comp, g, "cutrotate", 7)
    assert not torch.equal(ts.descramble(tp, scr, g, "cutrotate", 8), comp)


def test_refusals_match_jax():
    jp = get_plan("ntsc")
    tp = plan_from_numpy(jp)
    g = np.arange(48, dtype=np.int32)[None]
    comp = np.zeros((1, 48, 720), np.float32)
    for mod, c, gl in ((js, jnp.asarray(comp), jnp.asarray(g)),
                       (ts, torch.tensor(comp), torch.tensor(g))):
        with pytest.raises(ValueError, match="divisible by 32"):
            mod.scramble(jp if mod is js else tp, c, gl, "shuffle", 1)
        with pytest.raises(ValueError, match="mode must be one of"):
            mod.descramble(jp if mod is js else tp, c, gl, "linecut", 1)
