"""The PyTorch port's chunked, resumable video runner
(``color_modem_tpu_torch/frame/video.py``), its manifest and its
fingerprint, against the JAX package on the CPU.

Bounds: the clean run's ``min_psnr_db`` equals the JAX ``xla`` run's to
0.01 dB and its saved frames agree to 5e-4 (the RGB bound of
tests/test_torch_pipeline.py); chunk independence 1e-6, as in
tests/test_video.py; the fingerprint 1e-4 relative to ``fingerprint_jnp``;
the device source 1e-6; the transmission hops and the equalizer against
the JAX runner's noise-free runs to 0.02 dB and 1e-4 (5e-4 through the
satellite hop's float32 FM phase).  The data services (``caption_bits``,
``scramble``) against the JAX runner to 0.02 dB and 1e-4, the caption bits
exactly; chunk sizes 1e-6 apart (1e-5 through the RF hop).  Noise is the
JAX runner's, drawn from the same keys (``utils/prng.py``): the noisy runs
(channel noise, with NR, through the RF hop, the noisy GCR record, the
satellite hop at 12 dB CNR) are held to the JAX runner's at the noise-free
bounds, and their manifests record JAX's ``"abs-frame"``.
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
    NOISE_KEYING,
    process_video,
    synthetic_device_source,
    synthetic_source,
)
from color_modem_tpu_torch.kernels import launch_counts, reset_launches
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils.manifest import ChunkManifest, array_hash
from color_modem_tpu_torch.utils.metrics import fingerprint, fingerprint_hex
from torch_threads import one_torch_thread  # noqa: F401

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
    reset_launches()
    yield
    assert set(launch_counts().values()) == {0}


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
    """The manifest layouts are the same: a JAX-written manifest, with only
    its backend name changed, resumes in the port, a noisy one too, since
    the port draws JAX's noise and records JAX's keying; another keying
    refuses."""
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
        s = process_video(tplan(), src, 2, d, decoder="notch", chunk=2, channel=chan,
                          device="cpu")
        assert s["frames_processed_this_run"] == 0
        if chan is not None:
            assert m["config"]["noise_keying"] == NOISE_KEYING == "abs-frame"
            m["config"]["noise_keying"] = "abs-frame-torch-cpu"
            with open(path, "w") as f:
                json.dump(m, f)
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
    """The noisy channel with and without NR against the JAX runner on the
    same keys (0.01 dB, frames to 5e-4), NR's gain, JAX's keying."""
    noise = {"noise_sigma": 0.02}
    runs = {}
    for name, nr in (("raw", False), ("den", True)):
        d, dj = str(tmp_path / name), str(tmp_path / f"{name}_jax")
        runs[name] = process_video(tplan(), static_source(3), 4, d, decoder="comb3", chunk=4,
                                   channel=dict(noise), nr=nr, save_outputs=True,
                                   device="cpu")
        s_j = jvideo.process_video(get_plan("ntsc"), static_source(3), 4, dj,
                                   decoder="comb3", chunk=4, channel=dict(noise), nr=nr,
                                   save_outputs=True)
        assert abs(runs[name]["min_psnr_db"] - s_j["min_psnr_db"]) <= 0.01, (name, s_j)
        np.testing.assert_allclose(saved(d, 4, 4), saved(dj, 4, 4), rtol=0, atol=DEC_ATOL)
    raw, den = runs["raw"], runs["den"]
    assert den["min_psnr_db"] - raw["min_psnr_db"] > 2.5, (raw, den)
    assert den["noise_keying"] == "abs-frame"
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


#: case -> (process_video options, max |diff| of the saved frames against
#: the JAX runner's).  Satellite: the reference's float32 FM phase integral
#: (its cumsum) is off the float64 one by up to ~2e-4 rad per sample, which
#: moves the decoded RGB by ~1.5e-4 (tests/test_torch_satellite.py), hence
#: 5e-4 there, at 12 dB CNR too.  The noisy cases draw JAX's noise from the
#: same keys and keep their noise-free bounds.
HOP_CASES = {
    "rf": (dict(rf=True), 1e-4),
    "rf-interlaced": (dict(rf=True, interlaced=True), 1e-4),
    "satellite": (dict(satellite=True), 5e-4),
    "equalize": (dict(channel={"ghost_delay_us": 3.0, "ghost_gain": 0.3, "equalize": True}),
                 1e-4),
    "channel-noise": (dict(channel={"noise_sigma": 0.02}), 1e-4),
    "channel-noise-interlaced": (dict(channel={"noise_sigma": 0.02}, interlaced=True), 1e-4),
    "rf-noise": (dict(rf=True, channel={"noise_sigma": 0.02}), 1e-4),
    "equalize-noise": (dict(channel={"ghost_delay_us": 3.0, "ghost_gain": 0.3,
                                     "noise_sigma": 0.02, "equalize": True}), 1e-4),
    "satellite-cnr": (dict(satellite=True, sat_cnr=12.0), 5e-4),
}


@pytest.mark.parametrize("case", list(HOP_CASES))
def test_hop_runs_match_jax(case, tmp_path):
    """The transmission hops, the GCR equalizer and the noisy channel
    between encode and decode against the JAX runner: PSNR to 0.02 dB,
    frames to the case's bound, the same manifest keys."""
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
    for key in ("rf", "satellite", "sat_cnr", "channel", "noise_keying", "interlaced"):
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
    noisy GCR record draw from keys folded with absolute indices (or a
    fixed key), so the chunk size cannot change the output."""
    kw, n, chunks, atol = CHUNK_HOP_CASES[case]
    outs = {}
    for chunk in chunks:
        d = str(tmp_path / f"c{chunk}")
        s = process_video(tplan(), synthetic_source(L, N), n, d, decoder="comb3",
                          chunk=chunk, save_outputs=True, device="cpu", **kw)
        # as the JAX runner's manifest: where channel noise is drawn
        assert ("noise_keying" in s) == ("noise_sigma" in kw.get("channel", {}))
        outs[chunk] = saved(d, n, chunk)
    np.testing.assert_allclose(outs[chunks[0]], outs[chunks[1]], rtol=0, atol=atol)


def test_noise_families_do_not_collide(tmp_path):
    """The satellite noise differs from the channel noise of the same frame:
    its base key is ``PRNGKey(0x5A7)``, the channel's ``PRNGKey(0)``, the
    GCR record's ``PRNGKey(1)``, as in the JAX runner; indices past 2^32
    wrap as JAX's int32 arithmetic does.  A noisy satellite run equals the
    JAX runner's."""
    from color_modem_tpu_torch.frame import video as tvideo
    from color_modem_tpu_torch.utils import prng

    keys = (tvideo.CHANNEL_NOISE_KEY, tvideo.SAT_NOISE_KEY, tvideo.GCR_NOISE_KEY)
    assert keys == (prng.PRNGKey(0), prng.PRNGKey(0x5A7), prng.PRNGKey(1))
    x = torch.zeros(2, 8)
    a, b = (prng.add_normal(x, 1.0, k, 0) for k in keys[:2])
    assert not torch.equal(a, b)
    assert torch.equal(a[1], prng.normal(prng.fold_in(keys[0], 1), (8,), "cpu"))
    assert torch.equal(prng.add_normal(x, 1.0, keys[1], 2**32 - 1)[1], b[0])
    d, dj = str(tmp_path / "s"), str(tmp_path / "j")
    s = process_video(tplan(), synthetic_source(L, N), 2, d, decoder="notch", chunk=2,
                      satellite=True, sat_cnr=14.0, save_outputs=True, device="cpu")
    s_j = jvideo.process_video(get_plan("ntsc"), synthetic_source(L, N), 2, dj,
                               decoder="notch", chunk=2, satellite=True, sat_cnr=14.0,
                               save_outputs=True)
    assert s["sat_cnr"] == 14.0 and s["satellite"] is True and s["min_psnr_db"] > 25.0
    assert abs(s["min_psnr_db"] - s_j["min_psnr_db"]) <= 0.02, (s, s_j)
    np.testing.assert_allclose(saved(d, 2, 2), saved(dj, 2, 2), rtol=0, atol=5e-4)


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


# --- a soundtrack on the RF hop's FM sound carrier --------------------------------


def _soundtrack(n, lines=L):
    t = np.arange(n * lines * N) / get_plan("ntsc").fs
    return (0.5 * np.sin(2 * np.pi * 700 * t) + 0.3 * np.sin(2 * np.pi * 4000 * t)).astype(
        np.float32)


def _audio_files(d):
    import glob

    return np.concatenate([np.load(p) for p in sorted(glob.glob(os.path.join(d, "aud_*.npy")))])


def _audio_snr(got, want, crop=8192):
    e = got[crop:-crop] - want[crop:-crop]
    return 10 * np.log10(np.mean(want[crop:-crop] ** 2) / np.mean(e ** 2))


@pytest.mark.parametrize("interlaced,n,chunks", [(False, 5, (2, 3)), (True, 4, (2, 4))],
                         ids=["progressive", "interlaced"])
def test_rf_audio_is_chunk_independent(interlaced, n, chunks, tmp_path):
    """The sound carrier's deviation phase continues across frames (joined
    streams) and chunks (the float64 prefix), so the audio keeps the
    single-shot quality (>= 55 dB, tests/test_video.py) and does not
    depend on the chunk size (1e-4)."""
    aud = _soundtrack(n)
    outs = {}
    for chunk in chunks:
        d = str(tmp_path / f"s{chunk}")
        s = process_video(tplan(), synthetic_source(L, N), n, d, decoder="notch",
                          chunk=chunk, rf=True, rf_audio=aud, interlaced=interlaced,
                          device="cpu")
        assert s["frames_processed_this_run"] == n and s["rf_audio"] is True
        got = _audio_files(d)
        assert got.shape == aud.shape and _audio_snr(got, aud) >= 55.0
        outs[chunk] = got
    np.testing.assert_allclose(outs[chunks[0]], outs[chunks[1]], atol=1e-4, rtol=0)


def test_rf_audio_matches_jax(tmp_path):
    """The same soundtrack through the JAX runner: PSNR to 0.02 dB, frames
    to 1e-4 (the RF hop's bound), audio files to 1e-4, the manifest
    configs alike."""
    aud = _soundtrack(4)
    kw = dict(decoder="comb3", chunk=2, save_outputs=True, rf=True, rf_audio=aud)
    s_j = jvideo.process_video(get_plan("ntsc"), synthetic_source(L, N), 4,
                               str(tmp_path / "j"), **kw)
    s = process_video(tplan(), synthetic_source(L, N), 4, str(tmp_path / "t"),
                      device="cpu", **kw)
    assert abs(s["min_psnr_db"] - s_j["min_psnr_db"]) <= 0.02, (s, s_j)
    np.testing.assert_allclose(saved(str(tmp_path / "t"), 4, 2),
                               saved(str(tmp_path / "j"), 4, 2), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_audio_files(str(tmp_path / "t")),
                               _audio_files(str(tmp_path / "j")), rtol=0, atol=1e-4)
    configs = []
    for d in ("t", "j"):
        with open(os.path.join(str(tmp_path / d), "manifest.json")) as f:
            configs.append(json.load(f)["config"])
    for key in ("rf", "rf_audio", "rf_audio_bw"):
        assert configs[0].get(key) == configs[1].get(key), key


def test_rf_audio_options_refuse(tmp_path):
    """rf_audio needs the RF hop; a resume without the soundtrack, or with
    another sound bandwidth, refuses to mix chunks; a track that is not a
    whole number of per-frame blocks raises."""
    aud = _soundtrack(2)
    with pytest.raises(ValueError, match="rf=True"):
        process_video(tplan(), synthetic_source(L, N), 2, str(tmp_path / "x"), chunk=2,
                      rf_audio=aud, device="cpu")
    d = str(tmp_path / "s")
    process_video(tplan(), synthetic_source(L, N), 2, d, chunk=2, rf=True, rf_audio=aud,
                  device="cpu")
    for kw in ({}, {"rf_audio": aud, "rf_audio_bw": 50e3}):
        with pytest.raises(ValueError, match="refusing to resume"):
            process_video(tplan(), synthetic_source(L, N), 2, d, chunk=2, rf=True,
                          device="cpu", **kw)
    with pytest.raises(ValueError, match="per-frame blocks"):
        process_video(tplan(), synthetic_source(L, N), 3, str(tmp_path / "y"), chunk=2,
                      rf=True, rf_audio=aud[:-1], device="cpu")
    s = process_video(tplan(), synthetic_source(L, N), 2, str(tmp_path / "w"), chunk=2,
                      rf=True, rf_audio=aud, rf_audio_bw=50e3, device="cpu")
    assert s["rf_audio_bw"] == 50e3


def _caption_bits(text, n):
    from color_modem_tpu_torch.frame.vbi import cc_pack

    padded = text.ljust(2 * n)
    return padded, np.stack([cc_pack(padded[2 * i : 2 * i + 2]).numpy() for i in range(n)])


def _captions(d):
    """The decoded cells of every chunk file, in order, and their text."""
    from color_modem_tpu_torch.frame.vbi import cc_unpack

    files = sorted(f for f in os.listdir(d) if f.startswith("cc_"))
    bits = np.concatenate([np.load(os.path.join(d, f)) for f in files])
    cells = [cc_unpack(row) for row in bits]
    return bits, "".join(c for c, _ in cells), all(ok for _, ok in cells)


#: case -> (process_video options, frames, max |diff| against the JAX runner)
SERVICE_CASES = {
    "caption": (dict(caption=True), 5, 1e-4),
    "caption-interlaced": (dict(caption=True, interlaced=True), 5, 1e-4),
    "cutrotate": (dict(scramble=("cutrotate", 0xC0FFEE)), 4, 1e-4),
    "linedelay-interlaced": (dict(scramble=("linedelay", 7), interlaced=True), 4, 1e-4),
    "shuffle": (dict(scramble=("shuffle", 3)), 4, 1e-4),
    "caption-cutrotate-rf": (dict(caption=True, scramble=("cutrotate", 0x5EC4E7), rf=True),
                             5, 1e-4),
    "caption-cutrotate-interlaced": (dict(caption=True, scramble=("cutrotate", 9),
                                          interlaced=True), 5, 1e-4),
}


@pytest.mark.parametrize("case", list(SERVICE_CASES))
def test_services_match_jax(case, tmp_path):
    """Captions on row 0 (of each frame's first field when interlaced) and
    scrambling between the encoder and the hop, against the JAX runner:
    PSNR (the caption row left out) to 0.02 dB, frames to 1e-4, the decoded
    caption cells bit for bit and equal to those sent, the manifest keys."""
    kw, n, atol = SERVICE_CASES[case]
    kw = dict(kw)
    text = None
    if kw.pop("caption", False):
        text, kw["caption_bits"] = _caption_bits("CAPS 4 ALL", n)
    runs = {}
    for pkg, run, plan in (("j", jvideo.process_video, get_plan("ntsc")),
                           ("t", process_video, tplan())):
        d = str(tmp_path / pkg)
        extra = {"device": "cpu"} if pkg == "t" else {}
        runs[pkg] = run(plan, synthetic_source(L, N), n, d, decoder="comb3", chunk=2,
                        save_outputs=True, **kw, **extra)
    s, s_j = runs["t"], runs["j"]
    assert s["frames_processed_this_run"] == n
    assert abs(s["min_psnr_db"] - s_j["min_psnr_db"]) <= 0.02, (s, s_j)
    np.testing.assert_allclose(saved(str(tmp_path / "t"), n, 2),
                               saved(str(tmp_path / "j"), n, 2), rtol=0, atol=atol)
    for key in ("scramble", "scramble_key", "caption", "rf", "interlaced"):
        assert s.get(key) == s_j.get(key), key
    if text is not None:
        bits, got, ok = _captions(str(tmp_path / "t"))
        bits_j, _, _ = _captions(str(tmp_path / "j"))
        assert torch.equal(torch.tensor(bits), torch.tensor(bits_j.astype(np.int32)))
        assert bits.dtype == np.int32 and ok and got == text


@pytest.mark.parametrize("interlaced", [False, True])
def test_services_are_chunk_independent(interlaced, tmp_path):
    """Caption cells keyed by the absolute frame index and the scrambler
    keyed by the absolute line index (field-sequential when interlaced):
    chunks of 2 and 3 frames (the second starting on an odd frame, so its
    fields sit at other offsets in the batch) give the same frames, under
    channel noise, and the same caption cells; through the RF hop to 1e-5."""
    n = 6
    text, bits = _caption_bits("CHUNKED CAPS", n)
    for kw, atol in ((dict(channel={"noise_sigma": 0.01}), CHUNK_ATOL), (dict(rf=True), 1e-5)):
        outs, caps = {}, {}
        for chunk in (2, 3):
            d = str(tmp_path / f"{'rf' if 'rf' in kw else 'ch'}{chunk}")
            s = process_video(tplan(), synthetic_source(L, N), n, d, decoder="comb3",
                              chunk=chunk, interlaced=interlaced, caption_bits=bits,
                              scramble=("cutrotate", 0xC0FFEE), save_outputs=True,
                              device="cpu", **kw)
            assert s["min_psnr_db"] > 25.0, s
            outs[chunk] = saved(d, n, chunk)
            caps[chunk] = _captions(d)
        np.testing.assert_allclose(outs[2], outs[3], rtol=0, atol=atol)
        assert caps[2][1] == caps[3][1] == text and caps[2][2] and caps[3][2]


def test_clean_scramble_is_bit_transparent(tmp_path):
    """tests/test_video.py: on a clean channel, scrambled then descrambled
    output is bit-identical to the plain run's (gathers never touch a
    sample's value)."""
    outs = {}
    for name, kw in (("clear", {}), ("scr", {"scramble": ("linedelay", 7)})):
        d = str(tmp_path / name)
        process_video(tplan(), synthetic_source(L, N), 4, d, decoder="comb3", chunk=4,
                      interlaced=True, save_outputs=True, device="cpu", **kw)
        outs[name] = np.load(os.path.join(d, "rgb_000000.npy"))
    assert np.array_equal(outs["clear"], outs["scr"])


def test_service_options_refuse(tmp_path):
    """A resume with another key, or without the captions, refuses to mix
    chunks; scrambling refuses the GCR equalizer and an unknown mode."""
    _, bits = _caption_bits("KEY", 2)
    d = str(tmp_path / "s")
    process_video(tplan(), synthetic_source(L, N), 2, d, chunk=2, device="cpu",
                  scramble=("cutrotate", 1), caption_bits=bits)
    for kw in ({"scramble": ("cutrotate", 2), "caption_bits": bits},
               {"scramble": ("linedelay", 1), "caption_bits": bits},
               {"scramble": ("cutrotate", 1)}):
        with pytest.raises(ValueError, match="refusing to resume"):
            process_video(tplan(), synthetic_source(L, N), 2, d, chunk=2, device="cpu", **kw)
    s = process_video(tplan(), synthetic_source(L, N), 2, d, chunk=2, device="cpu",
                      scramble=("cutrotate", 1), caption_bits=bits)
    assert s["frames_processed_this_run"] == 0 and s["caption"] is True
    with pytest.raises(ValueError, match="GCR equalizer"):
        process_video(tplan(), synthetic_source(L, N), 2, str(tmp_path / "e"), device="cpu",
                      scramble=("cutrotate", 1),
                      channel={"ghost_delay_us": 3.0, "ghost_gain": 0.3, "equalize": True})
    with pytest.raises(ValueError, match="scramble mode"):
        process_video(tplan(), synthetic_source(L, N), 2, str(tmp_path / "m"), device="cpu",
                      scramble=("linecut", 1))
    with pytest.raises(ValueError, match="divisible by 32"):
        process_video(tplan(), synthetic_source(L, N), 2, str(tmp_path / "w"), device="cpu",
                      scramble=("shuffle", 1), interlaced=True)


def test_source_memory_is_never_shared(tmp_path):
    """A source may hand out read-only memory it does not own (a NumPy view
    of a JAX buffer, a memory map): the runner copies it onto the device
    instead of wrapping it (it warned, and on the CPU shared the memory)."""
    import warnings

    frames = np.stack([smooth_scene(L, N, seed=s) for s in range(2)]).astype(np.float32)
    frames.flags.writeable = False
    before = frames.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s = process_video(tplan(), lambda start, count: frames[start : start + count], 2,
                          str(tmp_path / "ro"), decoder="comb3", chunk=2, device="cpu",
                          caption_bits=np.zeros((2, 16), np.int32),
                          scramble=("cutrotate", 5))
    assert s["frames_processed_this_run"] == 2
    assert np.array_equal(frames, before)


@pytest.mark.parametrize("form", ["read-only", "broadcast", "list"])
def test_upload_is_a_copy_of_its_own(form):
    """``utils/upload.py`` on the CPU: the values cast to the asked dtype, in
    memory of the tensor's own, whatever the caller hands over (a read-only
    array, a broadcast view with zero strides, a list); no warning."""
    import warnings

    from color_modem_tpu_torch.utils.upload import upload

    base = np.random.default_rng(0).standard_normal((3, 5))
    arr = {"read-only": base.copy(), "broadcast": np.broadcast_to(base[:1], (3, 5)),
           "list": base.tolist()}[form]
    if form == "read-only":
        arr.flags.writeable = False
    want = np.asarray(arr).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = upload(arr, "cpu", np.float32)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, torch.from_numpy(want))
    got += 1.0
    assert np.array_equal(np.asarray(arr).astype(np.float32), want)
    assert upload([1, 2], "cpu").dtype == torch.int64
