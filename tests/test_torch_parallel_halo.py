"""The port's halo exchange, mesh and rank launcher
(``color_modem_tpu_torch/parallel/``) on CPU ranks, against the JAX
package.

* The halo exchange alone: every rank's extended block on 4 gloo ranks at
  the meshes (1,4), (2,2) and (4,1), line halos of depth 1 and 2 with both
  edge rules and frame halos, equal to the JAX package's ``halo_extend`` /
  ``halo_extend_frames`` run inside ``shard_map`` on the same meshes of
  the 8 virtual CPU devices; the extended block's line numbers computed
  from the mesh position equal the exchanged ones.
* A corrupted halo (every received top halo line scaled by 1.01) moves the
  decode away from the unsharded one: the equivalence checks would catch
  a broken exchange (the counterpart of tests/test_sharding.py's
  fault-injection test).
* The launcher (the counterpart of tests/test_distributed.py): a rank
  killed at start-up surfaces within 60 s with its id, exit code and log;
  two ranks give the single-process pipeline's output bit for bit.
* ``required_halo``, ``halo_edge_rule`` and ``pad_to_multiple`` equal to
  the JAX package's; the mesh's validation and the backend's.
"""

import os
import time

import numpy as np
import pytest
import torch
import jax
from jax.sharding import PartitionSpec as P

from conftest import get_plan
from color_modem_tpu.parallel import halo as jhalo
from color_modem_tpu.parallel import mesh as jmesh
from color_modem_tpu.parallel import sharded as jsharded
from color_modem_tpu.standards import ALL_STANDARDS
from color_modem_tpu.standards.decoders import allowed_decoders
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.parallel import halo, mesh, multihost as mh, sharded
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 4), (2, 2), (4, 1)]
LINE_HALOS = [(1, "reflect"), (2, "reflect"), (2, "copy")]
LINE_SHAPE = [4, 16, 2]
FRAME_SHAPE = [8, 4, 2]


def _halo_cases():
    cases = []
    for ms in MESHES:
        for h, edge in LINE_HALOS:
            cases.append({"name": f"halo:lines/{edge}{h}@{ms[0]}x{ms[1]}", "kind": "halo",
                          "mesh": list(ms), "shape": LINE_SHAPE, "h": h, "edge": edge,
                          "axis": "lineblk"})
        cases.append({"name": f"halo:frames@{ms[0]}x{ms[1]}", "kind": "halo",
                      "mesh": list(ms), "shape": FRAME_SHAPE, "h": 1, "axis": "frame"})
    cases.append({"name": "corrupt:ntsc/comb2@1x4", "kind": "corrupt", "mesh": [1, 4],
                  "standard": "ntsc", "decoder": "comb2", "frames": 1, "lines": 64})
    return cases


HALO_CASES = _halo_cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("halo_ranks")
    recs = mh.launch(HALO_CASES, 4, backend="gloo", device="cpu", outdir=str(out),
                     timeout=600.0)
    return out, recs


def _jax_ext(case):
    """Every device's extended block from the JAX package's halo functions
    in shard_map, in rank order (frame-major)."""
    fr, lb = case["mesh"]
    m = jmesh.make_mesh(fr, lb)
    x = np.arange(int(np.prod(case["shape"])), dtype=np.float32).reshape(case["shape"])
    spec = P("frame", "lineblk", None)
    if case["axis"] == "frame":
        def blk(xb):
            return jhalo.halo_extend_frames(xb, case["h"], "frame")
    else:
        def blk(xb):
            return jhalo.halo_extend(xb, case["h"], "lineblk", case["edge"])
    ext = np.asarray(jax.jit(jax.shard_map(blk, mesh=m, in_specs=spec, out_specs=spec))(x))
    b, l, n = ext.shape
    return ext.reshape(fr, b // fr, lb, l // lb, n).transpose(0, 2, 1, 3, 4).reshape(
        fr * lb, b // fr, l // lb, n)


@pytest.mark.parametrize("name", [c["name"] for c in HALO_CASES if c["kind"] == "halo"])
def test_halo_extend_matches_jax(name, ranks):
    out, recs = ranks
    case = next(c for c in HALO_CASES if c["name"] == name)
    got = np.load(out / mh._file(case))["ext"]
    np.testing.assert_array_equal(got, _jax_ext(case))
    if case["axis"] == "lineblk":
        assert all(next(r for r in rr if r["name"] == name)["rows_equal"] for rr in recs)


def test_halo_interior_and_edges(ranks):
    """The unit test of tests/test_sharding.py: 16 lines on the (1,4) ring,
    halo 2, reflect edges."""
    out, _ = ranks
    case = next(c for c in HALO_CASES if c["name"] == "halo:lines/reflect2@1x4")
    ext = np.load(out / mh._file(case))["ext"][:, 0, :, 0] / 2  # line numbers
    assert ext[0].tolist() == [2, 1, 0, 1, 2, 3, 4, 5]
    assert ext[1].tolist() == [2, 3, 4, 5, 6, 7, 8, 9]
    assert ext[3].tolist() == [10, 11, 12, 13, 14, 15, 14, 13]


def test_corrupted_halo_is_detected(ranks):
    _, recs = ranks
    r = next(r for r in recs[0] if r["name"] == "corrupt:ntsc/comb2@1x4")
    assert r["err"]["rt"] > 1e-6


def test_halo_argument_errors():
    x = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="halo must be >= 1"):
        halo.halo_extend(x, 0, None)
    with pytest.raises(ValueError, match="too small for halo 8"):
        halo.halo_extend(x, 8, None)
    with pytest.raises(ValueError, match="edge must be"):
        halo.halo_extend(x, 1, None, edge="wrap")
    with pytest.raises(ValueError, match="too small for halo 1"):
        halo.halo_extend_frames(torch.zeros(1, 4, 4), 1, None)


PAIRS = [(s, d) for s in sorted(ALL_STANDARDS) for d in allowed_decoders(ALL_STANDARDS[s]())]


@pytest.mark.parametrize("standard,decoder", PAIRS)
def test_required_halo_and_edge_rule_match_jax(standard, decoder):
    jp = get_plan(standard)
    tp = plan_from_numpy(jp)
    assert sharded.required_halo(tp, decoder) == jsharded.required_halo(jp, decoder)
    assert sharded.halo_edge_rule(tp, decoder) == jsharded.halo_edge_rule(jp, decoder)


@pytest.mark.parametrize("size,multiple", [(60, 8), (64, 8), (5, 4), (3, 4), (1, 4)])
def test_pad_to_multiple_matches_jax(size, multiple):
    x = np.arange(2 * size * 3, dtype=np.float32).reshape(2, size, 3)
    got, n = mesh.pad_to_multiple(x, 1, multiple)
    want, m = jmesh.pad_to_multiple(x, 1, multiple)
    assert n == m
    np.testing.assert_array_equal(got, want)


def test_nccl_refuses_ranks_sharing_a_card(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="one card per rank"):
        mesh.init_distributed("nccl")
    with pytest.raises(ValueError, match="backend must be one of"):
        mesh.init_distributed("mpi")
    assert not torch.distributed.is_initialized()


@pytest.fixture
def one_rank(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_mesh_validation(one_rank, monkeypatch):
    assert mesh.mesh_shape(None, None, 8) == (8, 1)
    assert mesh.mesh_shape(None, 4, 8) == (2, 4)
    assert mesh.mesh_shape(2, None, 8) == (2, 4)
    with pytest.raises(ValueError, match="needs more than 8 ranks"):
        mesh.mesh_shape(3, 3, 8)
    with pytest.raises(ValueError, match="leaves ranks out of 8"):
        mesh.mesh_shape(2, 2, 8)
    with pytest.raises(ValueError, match="needs more than 1 ranks"):
        mesh.make_mesh(3, 3, backend="gloo", device="cpu")
    m = mesh.make_mesh(backend="gloo", device="cpu")
    assert m.shape == {"frame": 1, "lineblk": 1} and m.backend == "gloo" and not m.staged
    # an initialised group of another backend is refused, not reused (one
    # card, as far as the card check can tell)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="runs 'gloo', not 'nccl'"):
        mesh.init_distributed("nccl")


def test_one_rank_mesh_is_the_unsharded_pipeline(one_rank):
    """A 1x1 mesh: halos concatenate the edge lines with no exchange, and
    the gather helpers return the block: the sharded pipeline is the
    unsharded one bit for bit."""
    m = mesh.make_mesh(1, 1, backend="gloo", device="cpu")
    plan = plan_from_numpy(get_plan("pal"))
    x = mh.fixture(2, 64)
    enc, dec, rt = sharded.make_sharded_pipeline(plan, m, "delayline", "plain")
    enc_u, dec_u, rt_u = make_pipeline(plan, "delayline", "plain", device="cpu")
    blk = mesh.local_block(m, x, "rgb")
    assert torch.equal(mesh.gather_blocks(m, rt(blk, 5), "rgb"), rt_u(x, 5))
    assert torch.equal(mesh.gather_blocks(m, enc(blk, 5), "composite"), enc_u(x, 5))


def test_dead_rank_surfaces_fast(tmp_path):
    """A rank that dies at start-up is reported within seconds, with its id,
    exit code and log, instead of the others blocking on the rendezvous."""
    env = dict(os.environ, **{mh.FAIL_ENV: "1"})
    t0 = time.monotonic()
    with pytest.raises(mh._WorkerFailed) as ei:
        mh._spawn_and_wait(2, ["--outdir", str(tmp_path), "--backend", "gloo",
                               "--device", "cpu"], env, REPO, timeout=300.0)
    assert ei.value.rank == 1 and ei.value.returncode == 3
    assert "fault injection" in ei.value.log
    assert time.monotonic() - t0 < 60.0


TWO_RANK_CASES = [dict(mh._case("pipeline", s, d, ms, 2), backend="plain", save=True)
                  for ms in [(2, 1), (1, 2)] for s, d in (("ntsc", "comb3"), ("secam", "interp"))]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_ranks")
    return out, mh.launch(TWO_RANK_CASES, 2, backend="gloo", device="cpu", outdir=str(out),
                          timeout=600.0)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2)])
def test_two_ranks_equal_one_process(mesh_shape, two_ranks):
    """Two ranks' gathered NTSC comb3 and SECAM interp round trips equal
    the single-process pipeline's bit for bit (SECAM to 1e-5, its plain
    FIR products on blocks of another line count)."""
    out, recs = two_ranks
    for std, dec, atol in (("ntsc", "comb3", 0.0), ("secam", "interp", 1e-5)):
        case = next(c for c in TWO_RANK_CASES
                    if c["standard"] == std and tuple(c["mesh"]) == mesh_shape)
        got = np.load(out / mh._file(case))["rt"]
        _, _, rt_u = make_pipeline(plan_from_numpy(get_plan(std)), dec, "plain", device="cpu")
        want = rt_u(mh.fixture(case["frames"], case["lines"]), 3).numpy()
        if atol:
            np.testing.assert_allclose(got, want, atol=atol, rtol=0)
        else:
            np.testing.assert_array_equal(got, want)
    assert [r["device"] for rr in recs for r in rr] == ["cpu"] * 2 * len(TWO_RANK_CASES)
