"""The port's benchmark (``color_modem_tpu_torch/benchmark.py``) and its CLI
verb on the CPU, against the JAX package's (``color_modem_tpu/benchmark.py``).

Each test runs in a temporary working directory, so no record lands in the
checkout's ``results/``.  On the CPU the numbers are host-clock times of
the plain code; what is held here is the protocol: the flags, the line, the
record's keys, the PSNR against the JAX round trip to 0.02 dB, the decoder
fallback, and the roofline's count of the work.
"""

import argparse
import ast
import json
import pathlib

import numpy as np
import pytest
import jax.numpy as jnp

from color_modem_tpu import benchmark as jax_bench
from color_modem_tpu.frame.pipeline import make_pipeline as jax_make_pipeline
from color_modem_tpu.modem.plan import make_plan as jax_make_plan
from color_modem_tpu.standards import NTSC as JAX_NTSC
from color_modem_tpu.standards import SECAM as JAX_SECAM
from color_modem_tpu.standards.decoders import allowed_decoders as jax_allowed
from color_modem_tpu.utils.metrics import psnr as jax_psnr
from color_modem_tpu.utils.testimages import smooth_scene as jax_smooth_scene
from color_modem_tpu_torch import benchmark, cli
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.standards import NTSC
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--batch", "2", "--lines", "32", "--iters", "2"]
LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
#: keys the port's record adds to the JAX benchmark's
NEW_KEYS = {"device_name", "power_limit_w", "spread_mpix_per_s", "kernel_launches",
            "seconds_per_call"}
#: the port's flags that differ from the JAX benchmark's: (JAX default, port default)
DIFFERENT = {"iters": (100, 20), "device": (None, "cuda"), "backend": ("auto", "kernel")}


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _defaults(add_args) -> dict:
    ap = argparse.ArgumentParser()
    add_args(ap)
    return {a.dest: a.default for a in ap._actions if a.dest != "help"}


def _jax_record_keys() -> set:
    """The keys of the dict the JAX benchmark assigns to ``record``."""
    tree = ast.parse((REPO / "color_modem_tpu" / "benchmark.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "record" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record dict in the JAX benchmark")


def _run(capsys, argv: list) -> tuple[list, dict, str]:
    """``benchmark.main(argv)``: its stdout lines, its record, its stderr."""
    benchmark.main(argv)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    last = json.loads(lines[-1])
    std, dec = last["metric"].split(" ")[0].split("-", 1)
    backend = "plain" if "--backend" in argv and argv[argv.index("--backend") + 1] == "plain" \
        else "kernel"
    with open(f"results/bench_{std}_{dec}_{backend}.json") as f:
        return lines, json.load(f), out.err


def test_flags_match_jax():
    jax_d, port_d = _defaults(jax_bench.add_bench_args), _defaults(benchmark.add_bench_args)
    for dest, (jd, pd) in DIFFERENT.items():
        assert (jax_d.get(dest), port_d[dest]) == (jd, pd), dest
    same = {k: v for k, v in jax_d.items() if k not in DIFFERENT}
    assert same == {k: port_d[k] for k in same}
    assert set(port_d) == set(jax_d) | set(DIFFERENT)
    ap = argparse.ArgumentParser()
    benchmark.add_bench_args(ap)
    for other in ("xla", "auto"):
        with pytest.raises(SystemExit):
            ap.parse_args(["--backend", other])


def test_line_and_record(capsys):
    lines, rec, _ = _run(capsys, SMALL + ["--backend", "plain"])
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS
    assert line["unit"] == "Mpix/s" and line["value"] > 0 and line["vs_baseline"] == line["value"]
    assert line["metric"].startswith("ntsc-comb3 roundtrip throughput (cpu, plain, 2x32x720, ")
    assert set(rec) == _jax_record_keys() | NEW_KEYS
    assert rec["backend"] == "plain" and rec["device"] == "cpu" and rec["shape"] == [2, 32, 720]
    assert rec["power_limit_w"] is None and rec["device_name"] == "cpu"
    lo, hi = rec["spread_mpix_per_s"]
    assert 0 < lo <= rec["mpix_per_s"] + 0.05 and rec["mpix_per_s"] - 0.05 <= hi
    # the plain backend launches no kernel; on the CPU neither does the kernel one
    assert set(rec["kernel_launches"].values()) == {0.0}
    assert "roofline" not in rec


@pytest.mark.parametrize("backend", ["plain", "kernel"])
def test_psnr_matches_jax(capsys, backend):
    _, rec, _ = _run(capsys, SMALL + ["--backend", backend])
    one = jax_smooth_scene(32, 720, seed=0)
    rgb = jnp.asarray(np.broadcast_to(one, (2, 3, 32, 720)), jnp.float32)
    _, _, rt = jax_make_pipeline(jax_make_plan(JAX_NTSC(), 720), "comb3", "xla")
    want = jax_psnr(np.asarray(rt(rgb, 0)), np.asarray(rgb))
    assert abs(rec["roundtrip_psnr_db"] - want) <= 0.02, (rec["roundtrip_psnr_db"], want)


def test_secam_decoder_fallback_matches_jax(capsys):
    argv = ["--standard", "secam", "--decoder", "comb3", "--batch", "1", "--lines", "16"]
    jax_bench.main(argv + ["--iters", "8", "--backend", "xla"])
    jax_err = capsys.readouterr().err.splitlines()[0]
    _, rec, err = _run(capsys, argv + ["--device", "cpu", "--iters", "1"])
    assert err.splitlines()[0] == jax_err
    assert rec["decoder"] == jax_allowed(JAX_SECAM())[0]
    with open(f"results/bench_secam_{rec['decoder']}_xla.json") as f:
        assert json.load(f)["decoder"] == rec["decoder"]


def test_roofline_counts_the_work_from_the_plan(capsys):
    b, l, n = 2, 32, 720
    recs = {backend: _run(capsys, SMALL + ["--backend", backend, "--roofline"])
            for backend in ("kernel", "plain")}
    taps = make_plan(NTSC(), n).c1_lpf.numel()
    # encode: the I and Q low-passes; decode: the band-pass and two low-passes;
    # two 3x3 colour matrices; RGB float32 read and written once
    flops = 2.0 * taps * (2 + 3) * b * l * n + 2 * 18 * b * l * n
    byt = 24.0 * b * l * n
    for backend, (lines, rec, _) in recs.items():
        assert len(lines) == 2 and set(json.loads(lines[-1])) == LINE_KEYS
        roof = json.loads(lines[0])["roofline"]
        assert roof == rec["roofline"]
        assert roof["flops_per_call"] == flops and roof["bytes_per_call"] == byt, backend
        # the CPU has no published peak: the bound, its constraint and
        # every share are null
        for key in ("bound_ms", "binding_constraint", "tflops_fraction_of_f32_peak",
                    "hbm_fraction_of_peak"):
            assert roof[key] is None, key
        assert roof["logical_tflops"] is not None and roof["hbm_gbps"] is not None


@pytest.mark.parametrize("hbm_gbps,f32_tflops,constraint", [
    (3350.0, 165.0, "operations"),  # the H100's peaks (kernels/measure.py)
    (3350.0, 1e4, "bytes"),
])
def test_roofline_bound_and_shares_from_one_peak_lookup(capsys, monkeypatch, hbm_gbps,
                                                        f32_tflops, constraint):
    from color_modem_tpu_torch.utils import profiling

    peaks = {"hbm_gbps": hbm_gbps, "f32_tflops": f32_tflops}
    seen = []
    monkeypatch.setattr(profiling, "chip_peaks", lambda dev: seen.append(dev) or dict(peaks))
    _, rec, _ = _run(capsys, SMALL + ["--backend", "plain", "--roofline"])
    roof, dt = rec["roofline"], rec["seconds_per_call"]
    assert len(seen) == 1
    flops, byt = roof["flops_per_call"], roof["bytes_per_call"]
    t_bytes, t_ops = byt / (hbm_gbps * 1e9), flops / (f32_tflops * 1e12)
    assert roof["binding_constraint"] == constraint
    assert roof["bound_ms"] == pytest.approx(1e3 * max(t_bytes, t_ops))
    assert roof["tflops_fraction_of_f32_peak"] == round(flops / dt / 1e12 / f32_tflops, 3)
    assert roof["hbm_fraction_of_peak"] == round(byt / dt / 1e9 / hbm_gbps, 3)


@pytest.mark.parametrize("standard,decoder,kernels", [
    ("ntsc", "comb3", ("qam_encode", "qam_decode")),
    ("ntsc", "combA", ("qam_encode",)),
    ("secam", "interp", ("secam_encode", "secam_decode")),
])
def test_roofline_kernels_follow_the_decoder(standard, decoder, kernels):
    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.kernels.measure import kernel_flops

    plan = make_plan(ALL_STANDARDS[standard](), 720)
    assert benchmark.path_kernels(plan, decoder) == kernels
    flops, byt = benchmark.logical_work(plan, decoder, 3, 40)
    assert flops == sum(kernel_flops(plan, k, 120) for k in kernels) + 36 * 120 * 720
    assert byt == 24 * 120 * 720


def test_cli_bench_parses_the_same_flags(monkeypatch):
    seen = []
    monkeypatch.setattr(benchmark, "run", seen.append)
    flags = ["--standard", "pal", "--decoder", "delayline", "--batch", "3", "--lines", "8",
             "--samples", "1440", "--iters", "4", "--backend", "plain", "--device", "cpu",
             "--roofline"]
    assert cli.main(["bench"] + flags) == 0
    ap = argparse.ArgumentParser()
    benchmark.add_bench_args(ap)
    got = {k: v for k, v in vars(seen[0]).items() if k != "cmd"}
    assert got == vars(ap.parse_args(flags))
    # the temporal decoders are refused by the still-image verbs, not by bench
    assert cli.main(["bench", "--decoder", "comb3d", "--device", "cpu"]) == 0
    assert seen[1].decoder == "comb3d"


def test_cuda_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benchmark.main(["--batch", "1", "--lines", "16", "--iters", "1"])
    assert not pathlib.Path("results").exists()


#: a stand-in ``nvidia-smi``: two cards, the second without a readable limit
FAKE_SMI = """#!/bin/sh
case "$*" in
  *uuid,power.limit*) printf 'GPU-aaaa-0001, 700.00\\nGPU-bbbb-0002, [N/A]\\n'; exit $SMI_RC ;;
esac
exit 9
"""


@pytest.mark.parametrize("uuid,rc,want", [
    ("aaaa-0001", 0, 700.0),      # torch's UUID has no "GPU-" prefix
    ("GPU-AAAA-0001", 0, 700.0),
    ("bbbb-0002", 0, None),       # [N/A]
    ("cccc-0003", 0, None),       # no such card
    ("aaaa-0001", 6, None),       # nvidia-smi fails
])
def test_power_limit_by_uuid_from_nvidia_smi(tmp_path, monkeypatch, uuid, rc, want):
    smi = tmp_path / "bin" / "nvidia-smi"
    smi.parent.mkdir()
    smi.write_text(FAKE_SMI)
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", str(smi.parent))
    monkeypatch.setenv("SMI_RC", str(rc))
    assert benchmark.card_power_limit_w(uuid) == want


def test_power_limit_without_nvidia_smi_or_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setenv("PATH", str(tmp_path))
    assert benchmark.card_power_limit_w("aaaa-0001") is None
    assert benchmark.power_limit_w(torch.device("cpu")) is None
