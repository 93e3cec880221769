"""The package root's one-call factories, the profiling helpers and the entry
points of the port, on the CPU, against the JAX package.

The factories (``color_modem_tpu_torch.make_pipeline``,
``make_interlaced_pipeline``, ``make_svideo_pipeline``, ``make_transcoder``)
take the same seeded ``smooth_scene`` frames as ``color_modem_tpu``'s and are
held stage by stage at the bounds of the port's pipeline tests
(``tests/test_torch_qam_family.py``, ``tests/test_torch_frame.py``): the
composite 2e-5 (SECAM 2e-4), the decode of JAX's composite and the round
trip 5e-4, the transcoded composite 5e-4.  ``entry()``'s step is held to
the JAX entry's step on the same input at the round trip's 5e-4;
``dryrun_multichip(4, device="cpu")`` runs on 4 gloo ranks on the CPU; its
default is the card, which raises here.
"""

import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import color_modem_tpu as cmt_jax
import color_modem_tpu_torch as cmt
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch import entry as port_entry
from color_modem_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
ENC_ATOL, SECAM_ENC_ATOL, DEC_ATOL = 2e-5, 2e-4, 5e-4
N = 720
BACKENDS = ("kernel", "plain")


def _frames(lines: int, seed: int, frames: int = 2) -> np.ndarray:
    return np.stack([smooth_scene(lines, N, seed=seed + f) for f in range(frames)]
                    ).astype(np.float32)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("standard,decoder", [("pal", "delayline"), ("ntsc", "comb3"),
                                              ("secam", "interp")])
def test_make_pipeline_matches_jax(standard, decoder, backend):
    x = _frames(32, seed=21)
    enc_j, dec_j, rt_j = cmt_jax.make_pipeline(standard, N, decoder)
    enc, dec, rt = cmt.make_pipeline(standard, N, decoder, backend, device="cpu")
    comp_j = np.array(enc_j(jnp.asarray(x), 3))
    comp = enc(x, 3)
    assert comp.device.type == "cpu" and comp.shape == comp_j.shape
    np.testing.assert_allclose(_np(comp), comp_j, atol=SECAM_ENC_ATOL if standard == "secam"
                               else ENC_ATOL)
    np.testing.assert_allclose(_np(dec(comp_j, 3)), np.asarray(dec_j(jnp.asarray(comp_j), 3)),
                               atol=DEC_ATOL)
    np.testing.assert_allclose(_np(rt(x, 3)), np.asarray(rt_j(jnp.asarray(x), 3)),
                               atol=DEC_ATOL)


def test_make_pipeline_raster_matches_jax():
    x = _frames(32, seed=23, frames=1)
    enc_j, _, _ = cmt_jax.make_pipeline("ntsc", N, "comb3", raster=True)
    enc, dec, _ = cmt.make_pipeline("ntsc", N, "comb3", raster=True, device="cpu")
    comp_j = np.array(enc_j(jnp.asarray(x), 0))
    np.testing.assert_allclose(_np(enc(x, 0)), comp_j, atol=ENC_ATOL)
    assert dec(comp_j, 0).shape == x.shape


@pytest.mark.parametrize("backend", BACKENDS)
def test_make_interlaced_pipeline_matches_jax(backend):
    x = _frames(32, seed=25)
    enc_j, _, rt_j = cmt_jax.make_interlaced_pipeline("ntsc", N, "comb3")
    enc, dec, rt = cmt.make_interlaced_pipeline("ntsc", N, "comb3", backend, device="cpu")
    comp_j = np.array(enc_j(jnp.asarray(x), 1))
    comp = enc(x, 1)
    assert comp.shape == comp_j.shape == (4, 16, N)
    np.testing.assert_allclose(_np(comp), comp_j, atol=ENC_ATOL)
    np.testing.assert_allclose(_np(rt(x, 1)), np.asarray(rt_j(jnp.asarray(x), 1)),
                               atol=DEC_ATOL)
    assert torch.equal(dec(comp, 1), rt(x, 1))


@pytest.mark.parametrize("backend", BACKENDS)
def test_make_svideo_pipeline_matches_jax(backend):
    x = _frames(32, seed=27)
    enc_j, dec_j, _ = cmt_jax.make_svideo_pipeline("ntsc", N)
    enc, dec, _ = cmt.make_svideo_pipeline("ntsc", N, backend, device="cpu")
    yc_j = np.array(enc_j(jnp.asarray(x), 2))
    yc = enc(x, 2)
    assert yc.shape == yc_j.shape == (2, 2, 32, N)
    np.testing.assert_allclose(_np(yc), yc_j, atol=ENC_ATOL)
    np.testing.assert_allclose(_np(dec(yc_j, 2)), np.asarray(dec_j(jnp.asarray(yc_j), 2)),
                               atol=DEC_ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_make_transcoder_matches_jax(backend):
    x = _frames(40, seed=29, frames=1)
    comp = np.array(cmt_jax.make_pipeline("ntsc", N, "comb3")[0](jnp.asarray(x), 0))
    want = np.asarray(cmt_jax.make_transcoder("ntsc", "pal", N)(jnp.asarray(comp), 0))
    got = cmt.make_transcoder("ntsc", "pal", N, backend=backend, device="cpu")(comp, 0)
    assert got.shape == want.shape == (1, 48, N)
    np.testing.assert_allclose(_np(got), want, atol=DEC_ATOL)


def test_factories_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: cmt.make_pipeline("ntsc"), lambda: cmt.make_interlaced_pipeline("pal"),
                 lambda: cmt.make_svideo_pipeline("ntsc"),
                 lambda: cmt.make_transcoder("ntsc", "pal")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]


def test_measure_on_the_cpu():
    a = torch.ones(256, 256)
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    rep = profiling.measure(fn, a, iters=3, bytes_moved=3 * 4 * 256 * 256, flops=2 * 256 ** 3)
    assert set(rep) == {"seconds_per_call", "spread_seconds", "hbm_gbps",
                        "hbm_fraction_of_peak", "tflops", "f32_fraction_of_peak"}
    lo, hi = rep["spread_seconds"]
    assert 0 < lo <= rep["seconds_per_call"] <= hi
    assert len(calls) == 1 + profiling.WINDOWS * 3
    assert rep["tflops"] == pytest.approx(2 * 256 ** 3 / rep["seconds_per_call"] / 1e12)
    # the CPU has no published peak
    assert rep["hbm_fraction_of_peak"] is None and rep["f32_fraction_of_peak"] is None
    assert set(profiling.measure(fn, a, iters=1)) == {"seconds_per_call", "spread_seconds"}


def test_chip_peaks():
    assert all(math.isnan(v) for v in profiling.chip_peaks("cpu").values())
    assert profiling.PEAKS["h100 80gb hbm3"] == {"hbm_gbps": 3350.0, "f32_tflops": 165.0}


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_the_jax_entry():
    step_j, (rgb_j,) = _jax_graft_entry().entry()
    step, (rgb,) = port_entry.entry(device="cpu")
    assert tuple(rgb.shape) == rgb_j.shape and rgb.dtype == torch.float32
    assert not rgb.any()
    out = step(rgb)
    assert out.shape == rgb.shape
    np.testing.assert_allclose(_np(out), np.asarray(step_j(jnp.asarray(rgb_j))), atol=DEC_ATOL)
    x = _frames(64, seed=31)
    np.testing.assert_allclose(_np(step(torch.from_numpy(x))),
                               np.asarray(step_j(jnp.asarray(x))), atol=DEC_ATOL)


@pytest.mark.parametrize("n,factoring", [(4, (1, 4)), (6, (3, 2)), (3, (3, 1))])
def test_mesh_factoring_as_jax(n, factoring):
    assert port_entry.mesh_factoring(n) == factoring


def test_dryrun_multichip_on_four_gloo_ranks(tmp_path, capsys):
    recs = port_entry.dryrun_multichip(4, device="cpu", outdir=str(tmp_path))
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh={'frame': 1, 'lineblk': 4}" in out
    assert "ranks on ['cpu', 'cpu', 'cpu', 'cpu']" in out
    by_name = {r["name"]: r for r in recs}
    assert by_name["step:ntsc/comb3"]["psnr"] > port_entry.MIN_PSNR_DB
    assert by_name["step:ntsc/comb3d"]["psnr"] > port_entry.MIN_PSNR_DB
    assert len(recs) > 20


def test_dryrun_multichip_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.dryrun_multichip(2, outdir=str(tmp_path))
    assert not any(tmp_path.iterdir())
