"""The port's sharded pipelines (``color_modem_tpu_torch/parallel/``) on 4
CPU ranks, against the port's unsharded pipelines and against the JAX
package.

One launch of 4 gloo ranks (``parallel/multihost.py``) runs the port's
counterpart of ``__graft_entry__.py::dryrun_multichip``'s case list at the
meshes (2,2), (4,1) and (1,4), on ``smooth_scene`` frames from a seed: 4
frames (8 for the temporal combs) x 64 lines x 720 samples, frame0 = 3,
``backend="plain"``, and the main path (NTSC comb3) once more through the
kernel wrappers (their plain versions on the CPU).  Rank 0 holds each case
against the same pipeline unsharded, at the JAX gate's bounds: QAM encode,
decode and round trip bit-identical, the adaptive comb3dA included (its
1e-6 on a card, ``multihost.ADAPTIVE_CUDA_BOUND``, does not apply to the
CPU); SECAM and MAC 1e-5; PALplus 1e-6; the
RF hop 2e-6; the satellite hop 1e-3; the RF hop with sound 2e-5 on the
video and 1e-5 on the audio; the satellite hop with audio 1e-3 and 1e-5.
(Measured: every QAM, MAC and hop case bit-identical on the CPU; SECAM
decodes 5.4e-7 apart, since its plain FIR products run on blocks of
another line count; the RF sound 5.1e-7, the float64 prefix phase
summed in another order.)

Against JAX (its unsharded pipelines on the CPU, the gathered outputs of
the (2,2) cases): the bounds of the port's unsharded tests for the same
path: composite 2e-5 (SECAM 2e-4), decoded RGB 5e-4 on the same
composite (tests/test_torch_pipeline.py, tests/test_torch_secam.py,
tests/test_torch_frame.py), MAC 1e-5 (tests/test_torch_mac.py), PALplus
5e-4 (tests/test_torch_palplus.py), the hops' frames 1e-4 and 5e-4
(tests/test_torch_video.py's hop cases; 1e-3 with the satellite's audio
ladder, see HOP_ATOL), the received audio >= 60 dB parity.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from conftest import get_plan
from color_modem_tpu_torch.parallel import multihost as mh
from torch_threads import one_torch_thread  # noqa: F401

N_RANKS = 4
MESHES = [(2, 2), (4, 1), (1, 4)]
FRAME0 = 3
ENC_ATOL, SECAM_ENC_ATOL, DEC_ATOL = 2e-5, 2e-4, 5e-4
MAC_ATOL = 1e-5
#: the satellite hop with its audio ladder: 1e-3, the JAX gate's own bound
#: for that chain, since the JAX package's float32 FM phase integral moves
#: its output by that much when only the batch's shape changes (measured
#: 5.9e-4 against the port's float64 integral here)
HOP_ATOL = {"rf-hop": 1e-4, "sat-hop": 5e-4, "rf-sound": 1e-4, "sat-audio": 1e-3}
AUDIO_PARITY_DB = 60.0


def _cases():
    cases = []
    for ms in MESHES:
        for c in mh.dryrun_cases(N_RANKS, *ms):
            c = dict(c, backend="plain", save=tuple(c["mesh"]) == (2, 2)
                     or c["kind"] == "palplus")
            if all(c["name"] != d["name"] for d in cases):
                cases.append(c)
    for ms in MESHES:
        c = mh._case("pipeline", "ntsc", "comb3", ms, N_RANKS)
        cases.append(dict(c, name="kernel-" + c["name"], backend="kernel"))
    return cases


CASES = _cases()
SAVED = [c for c in CASES if c.get("save")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    recs = mh.launch(CASES, N_RANKS, backend="gloo", device="cpu", outdir=str(out),
                     timeout=900.0)
    return out, {r["name"]: r for r in recs[0]}, recs


def test_case_list_covers_the_gate():
    kinds = {c["kind"] for c in CASES}
    assert kinds == {"pipeline", "interlaced", "mac", "palplus", "rf-hop", "sat-hop",
                     "rf-sound", "sat-audio"}
    assert {tuple(c["mesh"]) for c in CASES} == set(MESHES)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_sharded_equals_unsharded(name, ranks):
    _, rec0, _ = ranks
    r = rec0[name]
    assert r["finite"]
    bound = r["bound"]
    case = next(c for c in CASES if c["name"] == name)
    if case["kind"] in ("pipeline", "interlaced") and case["standard"] != "secam":
        assert bound == 0.0  # every QAM decoder bit-identical on the CPU
    if isinstance(bound, list):  # (video, audio)
        assert r["err"]["rt"] <= bound[0], r["err"]
        assert r["err"]["aud"] <= bound[1], r["err"]
    else:
        for key, err in r["err"].items():
            assert err <= bound, f"{name} {key}: {err} > {bound}"
    assert r["psnr"] > 20.0


def test_every_rank_ran_every_case_on_its_device(ranks):
    _, _, recs = ranks
    assert len(recs) == N_RANKS
    for rank, rr in enumerate(recs):
        assert [r["name"] for r in rr] == [c["name"] for c in CASES]
        assert all(r["rank"] == rank and r["device"] == "cpu" for r in rr)
        # CPU tensors run the plain versions: no kernel launched
        assert all(not any(r["launches"].values()) for r in rr)


def test_blocks_follow_the_mesh(ranks):
    _, _, recs = ranks
    for k, c in enumerate(CASES):
        fr, lb = c["mesh"]
        for rr in recs:
            assert rr[k]["block"] == [c["frames"] // fr, 3, c["lines"] // lb, 720], c["name"]


# --- against the JAX package ------------------------------------------------


def _saved(out, case):
    return np.load(out / mh._file(case))


def _jax_x(case):
    return jnp.asarray(mh.fixture(case["frames"], case["lines"]))


def _jax_pipeline(case):
    from color_modem_tpu.frame.interlace import make_interlaced_pipeline
    from color_modem_tpu.frame.pipeline import make_pipeline

    make = make_interlaced_pipeline if case["kind"] == "interlaced" else make_pipeline
    return make(get_plan(case["standard"]), case["decoder"])


def _parity_db(a, b):
    return 10.0 * np.log10(float(np.var(b)) / max(float(np.mean((a - b) ** 2)), 1e-300))


CODEC = [c for c in SAVED if c["kind"] in ("pipeline", "interlaced")]


@pytest.mark.parametrize("name", [c["name"] for c in CODEC])
def test_sharded_codec_against_jax(name, ranks):
    out, _, _ = ranks
    case = next(c for c in CODEC if c["name"] == name)
    got = _saved(out, case)
    enc, dec, _ = _jax_pipeline(case)
    enc_atol = SECAM_ENC_ATOL if case["standard"] == "secam" else ENC_ATOL
    np.testing.assert_allclose(got["enc"], np.asarray(enc(_jax_x(case), FRAME0)),
                               atol=enc_atol, rtol=0)
    # the decoders on the same composite
    np.testing.assert_allclose(got["dec"], np.asarray(dec(jnp.asarray(got["comp_u"]), FRAME0)),
                               atol=DEC_ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["d2", "d"])
def test_sharded_mac_against_jax(variant, ranks):
    from color_modem_tpu.modem import mac as jmac

    out, _, _ = ranks
    case = next(c for c in SAVED if c["kind"] == "mac" and c["standard"] == variant)
    got = _saved(out, case)
    plan = jmac.make_mac_plan(720, variant)
    g = (FRAME0 + jnp.arange(case["frames"]))[:, None] * plan.cfg.total_lines \
        + jnp.arange(case["lines"])
    np.testing.assert_allclose(got["enc"], np.asarray(jmac.encode(plan, _jax_x(case), g)),
                               atol=MAC_ATOL, rtol=0)
    np.testing.assert_allclose(got["dec"], np.asarray(
        jmac.decode(plan, jnp.asarray(got["comp_u"]), g)), atol=MAC_ATOL, rtol=0)


def test_sharded_palplus_against_jax(ranks):
    from color_modem_tpu.frame.palplus import make_palplus_pipeline

    out, _, _ = ranks
    case = next(c for c in SAVED if c["kind"] == "palplus")
    _, _, rt = make_palplus_pipeline(get_plan("pal"), "comb3")
    np.testing.assert_allclose(_saved(out, case)["rt"],
                               np.asarray(rt(_jax_x(case), FRAME0)), atol=DEC_ATOL, rtol=0)


def _jax_hop_chain(case):
    """The JAX package's unsharded enc -> hop -> dec chain: (rgb, audio or
    None)."""
    from color_modem_tpu.frame import rf as jrf
    from color_modem_tpu.frame import satellite as jsat
    from color_modem_tpu.frame.pipeline import make_pipeline

    plan = get_plan(case["standard"])
    enc, dec, _ = make_pipeline(plan, case["decoder"])
    comp = enc(_jax_x(case), FRAME0)
    kind = case["kind"]
    if kind == "rf-hop":
        return dec(jrf.rf_roundtrip(jrf.make_rf_plan(plan), comp, FRAME0), FRAME0), None
    if kind == "sat-hop":
        sp = jsat.make_sat_plan(plan.fs, 720)
        return dec(jsat.fm_demodulate(sp, jsat.fm_modulate(sp, comp)), FRAME0), None
    if kind == "rf-sound":
        rfp = jrf.make_rf_plan(plan)
        aud = mh.sound_fixture(plan.fs, case["frames"], case["lines"])
        rf = jrf.rf_modulate(rfp, comp, FRAME0)
        rf = jrf.sound_on_rf(rfp, rf, FRAME0, jnp.asarray(aud), 0.0)
        return (dec(jrf.rf_demodulate(rfp, rf, FRAME0), FRAME0),
                jrf.sound_from_rf(rfp, rf, FRAME0))
    sp = jsat.make_sat_plan(plan.fs, 720, audio_subs=2)
    fm = jsat.fm_modulate(sp, comp, audio=jnp.asarray(
        mh.sat_audio_fixture(plan.fs, case["frames"], case["lines"])))
    return dec(jsat.fm_demodulate(sp, fm), FRAME0), jsat.fm_demodulate_audio(sp, fm)


HOPS = [c for c in SAVED if c["kind"] in HOP_ATOL]


@pytest.mark.parametrize("name", [c["name"] for c in HOPS])
def test_sharded_hops_against_jax(name, ranks):
    out, _, _ = ranks
    case = next(c for c in HOPS if c["name"] == name)
    got = _saved(out, case)
    rgb, aud = _jax_hop_chain(case)
    np.testing.assert_allclose(got["rt"], np.asarray(rgb), atol=HOP_ATOL[case["kind"]], rtol=0)
    if aud is not None:
        aud = np.asarray(aud).reshape(got["aud"].shape)
        assert _parity_db(got["aud"], aud) >= AUDIO_PARITY_DB
