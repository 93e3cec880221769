"""``portbench/work.py`` against the program's own arithmetic as it stands:
the frozen copy counts the same flops, planes and round-trip work at both
configurations' shapes; only the operations peak differs (dense TF32, three
times the rate the program's bound takes)."""

import json
from pathlib import Path

import pytest

from color_modem_tpu_torch import benchmark
from color_modem_tpu_torch.kernels import measure
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.standards import ALL_STANDARDS
from portbench import work

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
NAMES = ("ntsc-comb3", "secam-interp")


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def _plan(cfg):
    return make_plan(ALL_STANDARDS[cfg["standard"]](), cfg["samples"])


@pytest.mark.parametrize("name", NAMES)
def test_kernel_flops_and_planes_match_the_program(name):
    cfg = _cfg(name)
    plan = _plan(cfg)
    lines = 16 * cfg["lines"]
    assert work.kernels(cfg) == benchmark.path_kernels(plan, cfg["decoder"])
    for k in work.kernels(cfg):
        assert work.kernel_flops(cfg, k, lines) == measure.kernel_flops(plan, k, lines)
        assert work.PLANES[k] == measure.PLANES[k]


@pytest.mark.parametrize("name", NAMES)
def test_bounds_take_the_dense_tf32_peak(name):
    cfg = _cfg(name)
    plan = _plan(cfg)
    lines = 16 * cfg["lines"]
    assert work.HBM_BYTES_PER_S == measure.HBM_BYTES_PER_S
    assert work.TF32_FLOPS_PER_S == pytest.approx(3 * measure.FP32_FLOPS_PER_S)
    for k in work.kernels(cfg):
        ms, by = measure.kernel_bound(plan, k, lines)
        t_bytes = 4.0 * work.PLANES[k] * lines * cfg["samples"] / work.HBM_BYTES_PER_S
        t_ops = work.kernel_flops(cfg, k, lines) / work.TF32_FLOPS_PER_S
        assert work.kernel_bound_s(cfg, k, lines)[0] == pytest.approx(max(t_bytes, t_ops))
        if by == "bytes":
            assert ms == pytest.approx(1e3 * t_bytes)
        else:
            assert ms == pytest.approx(3e3 * t_ops)


@pytest.mark.parametrize("name", NAMES)
def test_roundtrip_work_matches_the_program(name):
    cfg = _cfg(name)
    plan = _plan(cfg)
    assert work.roundtrip_work(cfg, 16) == benchmark.logical_work(
        plan, cfg["decoder"], 16, cfg["lines"])
    assert work.MAT3_FLOPS == benchmark.MAT3_FLOPS and work.RGB_BYTES == benchmark.RGB_BYTES
