"""The PyTorch port's chunked, resumable video runner
(``color_modem_tpu_torch/frame/video.py``), its manifest and its
fingerprint, against the JAX package on the CPU.

Bounds: the clean run's ``min_psnr_db`` equals the JAX ``xla`` run's to
0.01 dB and its saved frames agree to 5e-4 (the RGB bound of
tests/test_torch_pipeline.py); chunk independence 1e-6, as in
tests/test_video.py; the fingerprint 1e-4 relative to ``fingerprint_jnp``;
the device source 1e-6; the transmission hops and the equalizer against
the JAX runner's noise-free runs to 0.02 dB and 1e-4 (5e-4 through the
satellite hop's float32 FM phase).  Noisy runs are compared by chunk independence
and dB gains only: the port's per-index ``torch.Generator`` noise is not
the JAX package's PRNG.
"""

import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import TEST_SAMPLES, get_plan
from color_modem_tpu.frame import video as jvideo
from color_modem_tpu.utils import manifest as jmanifest
from color_modem_tpu.utils.metrics import fingerprint_jnp
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.frame.video import (
    process_video,
    synthetic_device_source,
    synthetic_source,
)
from color_modem_tpu_torch.kernels import qam as qk
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils.manifest import ChunkManifest, array_hash
from color_modem_tpu_torch.utils.metrics import fingerprint, fingerprint_hex

L, N = 32, TEST_SAMPLES
DEC_ATOL, CHUNK_ATOL = 5e-4, 1e-6


def tplan(name="ntsc"):
    return plan_from_numpy(get_plan(name))


def static_source(seed):
    one = smooth_scene(L, N, seed=seed).astype(np.float32)
    return lambda start, count: np.broadcast_to(one, (count,) + one.shape)


def saved(d, n, chunk):
    return np.concatenate([np.load(os.path.join(d, f"rgb_{s:06d}.npy"))
                           for s in range(0, n, chunk)])


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    qk.reset_launches()
    yield
    assert qk.LAUNCHES == {"qam_encode": 0, "qam_decode": 0}


def test_video_run_and_resume(tmp_path):
    src = synthetic_source(L, N)
    out = str(tmp_path / "run")
    s1 = process_video(tplan(), src, 6, out, decoder="notch", chunk=2, device="cpu")
    assert s1["frames_processed_this_run"] == 6
    assert s1["min_psnr_db"] > 35 and s1["backend"] == "kernel"
    s2 = process_video(tplan(), src, 6, out, decoder="notch", chunk=2, device="cpu")
    assert s2["frames_processed_this_run"] == 0
    assert ChunkManifest(out).summary() == {"chunks_done": 3, "frames_done": 6}
    results = sorted(os.listdir(os.path.join(out, "results")))
    assert len(results) == 2 and all(r.startswith("run_") for r in results)
    with open(os.path.join(out, "results", results[0])) as f:
        assert json.load(f)["standard"] == "ntsc"


def test_resume_rejects_config_change(tmp_path):
    src = synthetic_source(L, N)
    out = str(tmp_path / "run")
    process_video(tplan(), src, 2, out, decoder="notch", chunk=2, device="cpu")
    with pytest.raises(ValueError, match="refusing to resume"):
        process_video(tplan(), src, 2, out, decoder="comb3", chunk=2, device="cpu")
    with pytest.raises(ValueError, match="refusing to resume"):
        process_video(tplan(), src, 2, out, decoder="notch", chunk=2, backend="plain",
                      device="cpu")


def test_jax_manifests_resume_clean_and_refuse_noisy(tmp_path):
    """The manifest layouts are the same: a clean JAX-written manifest,
    with only its backend name changed, resumes in the port.  A noisy one
    refuses even then, because its noise keying is the JAX PRNG's."""
    src = synthetic_source(L, N)
    for name, chan in (("clean", None), ("noisy", {"noise_sigma": 0.02})):
        d = str(tmp_path / name)
        jvideo.process_video(get_plan("ntsc"), src, 2, d, decoder="notch", chunk=2,
                             channel=chan)
        path = os.path.join(d, "manifest.json")
        with open(path) as f:
            m = json.load(f)
        m["config"]["backend"] = "kernel"
        with open(path, "w") as f:
            json.dump(m, f)
        if chan is None:
            s = process_video(tplan(), src, 2, d, decoder="notch", chunk=2, device="cpu")
            assert s["frames_processed_this_run"] == 0
        else:
            assert m["config"]["noise_keying"] == "abs-frame"
            with pytest.raises(ValueError, match="refusing to resume"):
                process_video(tplan(), src, 2, d, decoder="notch", chunk=2, channel=chan,
                              device="cpu")


@pytest.fixture(scope="module")
def jax_clean_run(tmp_path_factory):
    """The JAX xla run: NTSC comb3 on the device source, 5 frames in chunks
    of 2 (a padded tail chunk), outputs saved."""
    d = str(tmp_path_factory.mktemp("jax_clean"))
    s = jvideo.process_video(get_plan("ntsc"), jvideo.synthetic_device_source(L, N, seed=3),
                             5, d, decoder="comb3", chunk=2, save_outputs=True)
    return s, saved(d, 5, 2), jmanifest.ChunkManifest(d).data["chunks"]


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_clean_run_matches_jax(backend, jax_clean_run, tmp_path):
    s_j, frames_j, chunks_j = jax_clean_run
    d = str(tmp_path / backend)
    s = process_video(tplan(), synthetic_device_source(L, N, seed=3, device="cpu"), 5, d,
                      decoder="comb3", chunk=2, backend=backend, save_outputs=True,
                      device="cpu")
    assert s["frames_processed_this_run"] == 5
    assert abs(s["min_psnr_db"] - s_j["min_psnr_db"]) <= 0.01, (s, s_j)
    np.testing.assert_allclose(saved(d, 5, 2), frames_j, atol=DEC_ATOL)
    chunks = ChunkManifest(d).data["chunks"]
    assert sorted(chunks) == sorted(chunks_j) == ["0-2", "2-4", "4-5"]
    for key, info in chunks.items():
        assert abs(info["psnr"] - chunks_j[key]["psnr"]) <= 0.01, key


def test_device_source_matches_jax():
    src_j = jvideo.synthetic_device_source(L, N, seed=1)
    src = synthetic_device_source(L, N, seed=1, device="cpu")
    got = src(5, 3)
    assert got.dtype == torch.float32 and got.shape == (3, 3, L, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(src_j(5, 3)), atol=1e-6)
    assert torch.equal(src(6, 1)[0], got[1])


def test_video_interlaced(tmp_path):
    s = process_video(tplan(), synthetic_source(L, N), 4, str(tmp_path / "int"),
                      decoder="comb3", chunk=2, interlaced=True, device="cpu")
    assert s["frames_processed_this_run"] == 4 and s["interlaced"] is True
    assert s["min_psnr_db"] > 33
    # same-parity temporal comb with the chunk overlap, on a static source
    s3d = process_video(tplan(), static_source(0), 4, str(tmp_path / "int3d"),
                        decoder="comb3d", chunk=2, interlaced=True, device="cpu")
    assert s3d["frames_processed_this_run"] == 4 and s3d["min_psnr_db"] > 40


def test_video_nr_and_tail_padding(tmp_path):
    noise = {"noise_sigma": 0.02}
    raw = process_video(tplan(), static_source(3), 4, str(tmp_path / "raw"),
                        decoder="comb3", chunk=4, channel=dict(noise), device="cpu")
    den = process_video(tplan(), static_source(3), 4, str(tmp_path / "den"),
                        decoder="comb3", chunk=4, channel=dict(noise), nr=True, device="cpu")
    assert den["min_psnr_db"] - raw["min_psnr_db"] > 2.5, (raw, den)
    assert den["noise_keying"] == "abs-frame-torch-cpu"
    # a one-frame tail chunk pads with repeats of its last frame
    d = str(tmp_path / "tail")
    s = process_video(tplan(), static_source(3), 5, d, decoder="comb3", chunk=4,
                      channel=dict(noise), nr=True, save_outputs=True, device="cpu")
    assert s["frames_processed_this_run"] == 5
    assert np.load(os.path.join(d, "rgb_000004.npy")).shape == (1, 3, L, N)


#: case -> (process_video options, frames, the two chunk sizes compared)
INDEPENDENCE_CASES = {
    "nr": (dict(decoder="comb3", nr=True, nr_sigma=0.5), 6, (2, 6)),
    "noise-nr": (dict(decoder="comb3", nr=True, channel={"noise_sigma": 0.02}), 6, (2, 6)),
    "noise-interlaced": (dict(decoder="comb3", interlaced=True,
                              channel={"noise_sigma": 0.02}), 4, (2, 4)),
    "noise-nr-comb3d": (dict(decoder="comb3d", interlaced=True, nr=True,
                             channel={"noise_sigma": 0.02}), 6, (2, 3)),
}


@pytest.mark.parametrize("case", list(INDEPENDENCE_CASES))
def test_chunk_independent(case, tmp_path):
    """True neighbours across chunk edges (the overlap fetch) and noise keyed
    on the absolute frame (field) index make the output independent of the
    chunk size."""
    kw, n, chunks = INDEPENDENCE_CASES[case]
    outs = {}
    for chunk in chunks:
        d = str(tmp_path / f"c{chunk}")
        process_video(tplan(), synthetic_source(L, N), n, d, chunk=chunk,
                      save_outputs=True, device="cpu", **kw)
        outs[chunk] = saved(d, n, chunk)
    np.testing.assert_allclose(outs[chunks[0]], outs[chunks[1]], atol=CHUNK_ATOL, rtol=0)


@pytest.mark.parametrize("option,value,item", [
    ("mesh", object(), "item 10"),
    ("rf_audio", np.zeros(4, np.float32), "item 8"),
    ("rf_audio_bw", 50e3, "item 8"),
    ("caption_bits", np.zeros((2, 16), np.int32), "item 9"),
    ("scramble", ("linecut", 7), "item 9"),
])
def test_unported_options_raise(option, value, item, tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        process_video(tplan(), synthetic_source(L, N), 2, str(tmp_path / "x"),
                      **{option: value})
    assert not os.path.exists(tmp_path / "x")


#: case -> (process_video options, max |diff| of the saved frames against
#: the JAX runner's).  Satellite: the reference's float32 FM phase integral
#: (its cumsum) is off the float64 one by up to ~2e-4 rad per sample, which
#: moves the decoded RGB by ~1.5e-4 (tests/test_torch_satellite.py), hence
#: 5e-4 there.
HOP_CASES = {
    "rf": (dict(rf=True), 1e-4),
    "rf-interlaced": (dict(rf=True, interlaced=True), 1e-4),
    "satellite": (dict(satellite=True), 5e-4),
    "equalize": (dict(channel={"ghost_delay_us": 3.0, "ghost_gain": 0.3, "equalize": True}),
                 1e-4),
}


@pytest.mark.parametrize("case", list(HOP_CASES))
def test_hop_runs_match_jax(case, tmp_path):
    """The transmission hops and the GCR equalizer between encode and decode,
    noise-free, against the JAX runner: PSNR to 0.02 dB, frames to the
    case's bound."""
    kw, atol = HOP_CASES[case]
    s_j = jvideo.process_video(get_plan("ntsc"), synthetic_source(L, N), 4,
                               str(tmp_path / "j"), decoder="comb3", chunk=2,
                               save_outputs=True, **kw)
    s = process_video(tplan(), synthetic_source(L, N), 4, str(tmp_path / "t"),
                      decoder="comb3", chunk=2, save_outputs=True, device="cpu", **kw)
    assert s["frames_processed_this_run"] == 4
    assert abs(s["min_psnr_db"] - s_j["min_psnr_db"]) <= 0.02, (s, s_j)
    np.testing.assert_allclose(saved(str(tmp_path / "t"), 4, 2),
                               saved(str(tmp_path / "j"), 4, 2), rtol=0, atol=atol)
    with open(os.path.join(str(tmp_path / "t"), "manifest.json")) as f:
        config = json.load(f)["config"]
    with open(os.path.join(str(tmp_path / "j"), "manifest.json")) as f:
        config_j = json.load(f)["config"]
    for key in ("rf", "satellite", "sat_cnr", "channel"):
        assert config.get(key) == config_j.get(key), key


#: case -> (process_video options, frames, the two chunk sizes, bound).  The
#: FFTs' rounding depends on the batch; near the FM threshold (12 dB CNR)
#: the discriminator carries a last-bit change of a noisy sample further.
CHUNK_HOP_CASES = {
    "satellite": (dict(satellite=True), 5, (2, 3), 1e-5),
    "satellite-cnr": (dict(satellite=True, sat_cnr=12.0), 5, (2, 3), 5e-4),
    "rf-noise": (dict(rf=True, channel={"noise_sigma": 0.02}), 5, (2, 3), 1e-5),
    "equalize-noise": (dict(channel={"ghost_delay_us": 3.0, "ghost_gain": 0.3,
                                     "noise_sigma": 0.02, "equalize": True}), 5, (2, 3), 1e-5),
}


@pytest.mark.parametrize("case", list(CHUNK_HOP_CASES))
def test_hop_runs_are_chunk_independent(case, tmp_path):
    """The hops are frame-local, and satellite noise, channel noise and the
    noisy GCR record draw from generators keyed on absolute indices (or a
    fixed seed), so the chunk size cannot change the output."""
    kw, n, chunks, atol = CHUNK_HOP_CASES[case]
    outs = {}
    for chunk in chunks:
        d = str(tmp_path / f"c{chunk}")
        s = process_video(tplan(), synthetic_source(L, N), n, d, decoder="comb3",
                          chunk=chunk, save_outputs=True, device="cpu", **kw)
        assert ("noise_keying" in s) == (case != "satellite")
        outs[chunk] = saved(d, n, chunk)
    np.testing.assert_allclose(outs[chunks[0]], outs[chunks[1]], rtol=0, atol=atol)


def test_noise_families_do_not_collide(tmp_path):
    """The satellite noise differs from the channel noise of the same frame:
    its seeds start at SAT_NOISE_SEED, the GCR record's at GCR_NOISE_SEED."""
    from color_modem_tpu_torch.frame import video as tvideo

    assert tvideo.SAT_NOISE_SEED == 2**30 and tvideo.GCR_NOISE_SEED == 2**31
    a = tvideo._unit_noise((8,), [0, 1], torch.device("cpu"))
    b = tvideo._unit_noise((8,), [tvideo.SAT_NOISE_SEED, tvideo.SAT_NOISE_SEED + 1],
                           torch.device("cpu"))
    assert not torch.equal(a, b)
    assert torch.equal(a[1], torch.randn(8, generator=torch.Generator().manual_seed(1)))
    s = process_video(tplan(), synthetic_source(L, N), 2, str(tmp_path / "s"),
                      decoder="notch", chunk=2, satellite=True, sat_cnr=14.0, device="cpu")
    assert s["sat_cnr"] == 14.0 and s["satellite"] is True and s["min_psnr_db"] > 25.0
    with pytest.raises(ValueError, match="2\\^30"):
        tvideo._index(2**30 - 1, 2)


def test_satellite_and_rf_together_raise(tmp_path):
    with pytest.raises(ValueError, match="pick one"):
        process_video(tplan(), synthetic_source(L, N), 2, str(tmp_path / "x"),
                      rf=True, satellite=True, device="cpu")
    assert not os.path.exists(tmp_path / "x")


def test_fingerprint_matches_jax_and_is_deterministic():
    x = np.random.default_rng(0).random((3, 3, 64, N)).astype(np.float32)
    fp = fingerprint(torch.from_numpy(x))
    assert fp.dtype == torch.float32 and fp.shape == (2,)
    np.testing.assert_allclose(fp.numpy(), np.asarray(fingerprint_jnp(jnp.asarray(x))), rtol=1e-4)
    assert torch.equal(fingerprint(torch.from_numpy(x)), fp)
    assert fingerprint_hex(fp) == fingerprint_hex(fp.numpy())
    assert len(fingerprint_hex(fp)) == 16


def test_fingerprint_tells_neighbours_apart_above_2_pow_24():
    """A float32 index would give the last two elements the same weight."""
    n = 2**24 + 8
    a, b = torch.zeros(n), torch.zeros(n)
    a[-1], b[-2] = 1.0, 1.0
    assert not torch.equal(fingerprint(a), fingerprint(b))
    np.testing.assert_allclose(fingerprint(a).numpy(),
                               np.asarray(fingerprint_jnp(jnp.asarray(a.numpy()))), rtol=1e-4)


def test_manifest_layout_and_hash_match_jax(tmp_path):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert array_hash(x) == jmanifest.array_hash(x)
    m = ChunkManifest(str(tmp_path))
    m.check_config({"standard": "ntsc", "nr": False})
    m.mark_done(0, 4, fp="00", psnr=40.0)
    j = jmanifest.ChunkManifest(str(tmp_path))
    assert j.data == m.data and j.summary() == m.summary()
    j.check_config({"standard": "ntsc"})  # a falsy "nr" counts as absent
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
