"""The port does all that the JAX package does, name by name.

An AST walk of every module of ``color_modem_tpu/`` against the module at
the same path in ``color_modem_tpu_torch/``.  Every public top-level name of a JAX module
(a function, class or assignment; in a package's ``__init__.py`` also what
it re-exports from the package) must be defined or imported by the port's
module, be a submodule the port has too, or stand in :data:`MAPPED`: either
the port's names that do its job (``"path.py::name"``, each checked to
exist) or the reason the port has no use for it.  One case per module.
"""

import ast
import pathlib

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX = REPO / "color_modem_tpu"
PORT = REPO / "color_modem_tpu_torch"

RELAY = "TPU-relay helper, ROADMAP North star"

#: (JAX module, name) -> the port's counterparts, or why it has none; the
#: name "*" stands for a whole module the port does not need
MAPPED = {
    ("dsp/apply.py", "fir_same_conv"): "the XLA convolution lowering of the plain FIR, one of "
        "the methods the JAX package chooses between per backend; the port's plain FIR is "
        "the Toeplitz product (dsp/apply.py::fir_same) and its kernels run the FIRs",
    ("dsp/apply.py", "set_default_method"): "selects between those lowerings; the port has "
        "one plain FIR method",
    ("dsp/rdft.py", "*"): RELAY + ": real DFT as matmuls because jnp.fft failed on the relay "
        "for non-smooth lengths; the port uses torch.fft (dsp/stream.py, "
        "dsp/apply.py::fir_same_fft)",
    ("kernels/common.py", "*"): "Pallas helpers (lane padding, VMEM limits, the bf16 split "
        "for the MXU, interpret mode); the CUDA kernels' counterparts are "
        "csrc/band_fir.cuh and kernels/tiles.py",
    ("kernels/__init__.py", "should_interpret"): "Pallas interpret mode on the CPU; a port "
        "wrapper runs its plain version on a CPU tensor (kernels/qam.py, kernels/secam.py)",
    ("utils/jitwrap.py", "*"): RELAY + ": self-jitting entry points for eager complex ops "
        "the relay could not dispatch; PyTorch runs them eagerly",
    ("utils/profiling.py", "force"): RELAY + ": a host readback to force execution through "
        "the relay; a CUDA event ends when the card has run the work before it",
    ("frame/__init__.py", "encode_block"): ["frame/pipeline.py::encode_block"],
    ("frame/__init__.py", "decode_block"): ["frame/pipeline.py::decode_block"],
    ("frame/__init__.py", "roundtrip_block"): ["frame/pipeline.py::roundtrip_block"],
    ("frame/__init__.py", "make_pipeline"): ["frame/pipeline.py::make_pipeline"],
    ("modem/__init__.py", "ModemPlan"): ["modem/plan.py::QamPlan", "modem/plan.py::FmPlan"],
    ("modem/__init__.py", "make_plan"): ["modem/plan.py::make_plan"],
    ("modem/plan.py", "ModemPlan"): ["modem/plan.py::QamPlan", "modem/plan.py::FmPlan"],
    ("separate/__init__.py", "separate"): ["separate/comb.py::separate"],
    ("separate/__init__.py", "average_with_neighbor"):
        ["separate/delayline.py::average_with_neighbor"],
    ("separate/__init__.py", "next_reflect"): ["separate/stencil.py::next_reflect"],
    ("separate/__init__.py", "prev_reflect"): ["separate/stencil.py::prev_reflect"],
    ("utils/__init__.py", "mse"): ["utils/metrics.py::mse"],
    ("utils/__init__.py", "psnr"): ["utils/metrics.py::psnr"],
    ("utils/__init__.py", "psnr_jnp"): ["utils/metrics.py::psnr"],
    ("utils/metrics.py", "psnr_jnp"): ["utils/metrics.py::psnr"],
    ("utils/metrics.py", "fingerprint_jnp"): ["utils/metrics.py::fingerprint"],
    ("parallel/__init__.py", "composite_sharding"): ["parallel/mesh.py::local_block"],
    ("parallel/__init__.py", "rgb_sharding"): ["parallel/mesh.py::local_block"],
    ("parallel/mesh.py", "composite_sharding"):
        ["parallel/mesh.py::local_block", "parallel/mesh.py::gather_blocks"],
    ("parallel/mesh.py", "rgb_sharding"):
        ["parallel/mesh.py::local_block", "parallel/mesh.py::gather_blocks"],
    ("parallel/multihost.py", "launch_smoke"): ["parallel/multihost.py::launch"],
    ("parallel/multihost.py", "reference_outputs"): ["parallel/multihost.py::run_case"],
    ("parallel/multihost.py", "sound_reference_outputs"): ["parallel/multihost.py::run_case"],
    ("parallel/multihost.py", "sharded_reference_outputs"): "one rank per block: no "
        "in-process sharded run exists to hold the ranks against; run_case holds them "
        "against the unsharded pipeline",
    **{("parallel/multihost.py", n): ["parallel/multihost.py::dryrun_cases"]
       for n in ("SMOKE_STANDARD", "SMOKE_DECODER", "SMOKE_FRAMES", "SMOKE_LINES",
                 "smoke_frames")},
}

#: the JAX package's root scripts -> the port's counterparts
ROOT_SCRIPTS = {
    "__graft_entry__.py": "entry.py",
    "bench.py": "benchmark.py",
}


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text())


def _defined(path: pathlib.Path) -> set:
    """Top-level functions, classes and assigned names."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {n.id for t in node.targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return names


def _imported(path: pathlib.Path, package_only: bool) -> set:
    names = set()
    for node in _tree(path).body:
        if isinstance(node, ast.ImportFrom) and (
                not package_only or (node.module or "").startswith("color_modem_tpu")):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import) and not package_only:
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


def jax_public(rel: str) -> set:
    path = JAX / rel
    names = _defined(path)
    if path.name == "__init__.py":
        names |= _imported(path, package_only=True)
    return {n for n in names if not n.startswith("_")}


def port_has(rel: str, name: str) -> bool:
    path = PORT / rel
    if not path.exists():
        return False
    if name in _defined(path) | _imported(path, package_only=False):
        return True
    # a submodule of the package
    return path.name == "__init__.py" and (
        (path.parent / f"{name}.py").exists() or (path.parent / name / "__init__.py").exists())


def _ref_exists(ref: str) -> bool:
    rel, name = ref.split("::")
    return name in _defined(PORT / rel)


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    missing, bad_refs = [], []
    for name in sorted(jax_public(rel)):
        if port_has(rel, name):
            continue
        target = MAPPED.get((rel, name), MAPPED.get((rel, "*")))
        if target is None:
            missing.append(name)
        elif isinstance(target, list):
            bad_refs += [ref for ref in target if not _ref_exists(ref)]
        else:
            assert target.strip(), (rel, name)
    assert not missing, f"{rel}: no port counterpart and no stated reason for {missing}"
    assert not bad_refs, f"{rel}: mapped to names the port does not define: {bad_refs}"


def test_every_mapping_is_still_needed():
    stale = []
    for (rel, name) in MAPPED:
        if name == "*":
            if (PORT / rel).exists() or not (JAX / rel).exists():
                stale.append((rel, name))
        elif name not in jax_public(rel) or port_has(rel, name):
            stale.append((rel, name))
    assert not stale, f"mappings for names the port now has or JAX no longer has: {stale}"


@pytest.mark.parametrize("script", sorted(ROOT_SCRIPTS))
def test_root_scripts_have_a_counterpart(script):
    port = ROOT_SCRIPTS[script]
    want = {n for n in _defined(REPO / script) if not n.startswith("_")}
    if script == "bench.py":
        # it calls the JAX benchmark's main
        want = {"main"}
    assert want <= _defined(PORT / port), (script, want - _defined(PORT / port))


def test_small_names_equal_jax_bit_for_bit():
    from color_modem_tpu.dsp.design import freqz as freqz_j
    from color_modem_tpu.frame import vbi as vbi_j
    from color_modem_tpu.frame import wss as wss_j
    from color_modem_tpu.separate.comb import SEPARATORS as SEP_J

    from color_modem_tpu_torch.dsp.design import freqz
    from color_modem_tpu_torch.frame import vbi, wss
    from color_modem_tpu_torch.separate.comb import SEPARATORS

    rng = np.random.default_rng(12)
    for ntaps in (1, 31, 129):
        taps = rng.standard_normal(ntaps)
        freqs = rng.uniform(0.0, 6.75e6, 257)
        got, want = freqz(taps, 13.5e6, freqs), freqz_j(taps, 13.5e6, freqs)
        assert got.dtype == want.dtype == np.complex128
        assert np.array_equal(got, want)
    assert SEPARATORS == SEP_J
    assert vbi.TWO_PI.hex() == vbi_j.TWO_PI.hex()
    assert wss.TWO_PI.hex() == wss_j.TWO_PI.hex()
