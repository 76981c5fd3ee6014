"""The port's RedMulE cycle and energy model (``repro_torch.core.perfmodel``)
against the reference's (``repro.core.perfmodel``): every public function at
``tests/test_perfmodel.py``'s points and more, equal value for value (pure
Python on both sides), and the roofline terms on the H100's peaks."""
import dataclasses
import itertools

import pytest

from repro.core import perfmodel as jpm
from repro_torch.core import perfmodel as pm
from repro_torch.roofline import analysis

INSTANCES = [("12x4", pm.REDMULE_12x4_FP16, jpm.REDMULE_12x4_FP16),
             ("12x8", pm.REDMULE_12x8_FP8, jpm.REDMULE_12x8_FP8)]
SHAPES = [(96, 96, 96), (8, 8, 8), (512, 512, 512), (1, 96, 96), (1, 3, 3), (13, 96, 96),
          (12, 16, 32), (100, 7, 250)] + [(m, 96, 96) for m in range(1, 25)]


def test_constants_equal_the_references():
    names = ["STARTUP_CYCLES", "Z_DRAIN_CYCLES", "SW_OPS_PER_CYCLE_GEMM", "SW_OPS_PER_CYCLE_G1",
             "SW_OPS_PER_CYCLE_G2", "SW_LAUNCH_OVERHEAD", "SW_OPS_PER_CYCLE_INT8",
             "FREQ_EFF_HZ", "FREQ_PERF_HZ", "POWER_W", "CLOCK_GATE_ROW_MAX",
             "CLOCK_GATE_FULL_MAX"]
    for name in names:
        assert getattr(pm, name) == getattr(jpm, name), name
    # No TPU number carries over.
    assert not [n for n in vars(pm) if n.startswith("TPU_")]


@pytest.mark.parametrize("name,inst,jinst", INSTANCES)
def test_instances_equal_the_references(name, inst, jinst):
    assert dataclasses.asdict(inst) == dataclasses.asdict(jinst)
    assert (inst.tile_cols, inst.n_ce, inst.elems_per_cycle) == (
        jinst.tile_cols, jinst.n_ce, jinst.elems_per_cycle)
    custom = pm.RedmuleInstance(L=8, H=2, P=1, elem_bits=8)
    jcustom = jpm.RedmuleInstance(L=8, H=2, P=1, elem_bits=8)
    assert (custom.tile_cols, custom.n_ce, custom.elems_per_cycle) == (
        jcustom.tile_cols, jcustom.n_ce, jcustom.elems_per_cycle)


@pytest.mark.parametrize("name,inst,jinst", INSTANCES)
def test_cycle_models_equal_the_references(name, inst, jinst):
    for m, n, k in SHAPES:
        assert dataclasses.asdict(pm.redmule_cycles(m, n, k, inst)) == dataclasses.asdict(
            jpm.redmule_cycles(m, n, k, jinst))
        for freq in (pm.FREQ_EFF_HZ, pm.FREQ_PERF_HZ):
            assert pm.gflops(m, n, k, inst, freq) == jpm.gflops(m, n, k, jinst, freq)
        for kind, point in itertools.product(("gemm", "g1", "g2"), ("eff", "perf")):
            assert pm.gflops_per_watt(m, n, k, inst, kind, point) == jpm.gflops_per_watt(
                m, n, k, jinst, kind, point)
        assert pm.clock_gating_power_factor(m, n, k, inst) == jpm.clock_gating_power_factor(
            m, n, k, jinst)


def test_software_baseline_equals_the_references():
    for (m, n, k), kind in itertools.product(SHAPES, ("gemm", "g1", "g2", "int8")):
        assert pm.sw_cycles(m, n, k, kind) == jpm.sw_cycles(m, n, k, kind)


def test_paper_points_hold_in_the_port():
    """The reference's own checks of the paper's points (Sec. 5.2.1, Table 2)."""
    assert abs(pm.redmule_cycles(96, 96, 96).utilization - 0.994) < 0.002
    assert abs(pm.gflops(96, 96, 96) - 58.5) < 0.3
    assert abs(pm.gflops(96, 96, 96, pm.REDMULE_12x8_FP8) - 117) < 1.5
    assert abs(pm.gflops_per_watt(96, 96, 96) - 755) < 25


def test_roofline_seconds_on_the_h100_peaks():
    r = pm.roofline_seconds(1e15, 1e12, 1e10, n_chips=4)
    assert r["compute_s"] == 1e15 / (4 * analysis.FP16_FLOP_S)
    assert r["memory_s"] == 1e12 / (4 * analysis.HBM_BYTES_S)
    assert r["collective_s"] == 1e10 / (4 * analysis.NVLINK_BYTES_S)
    assert r["bottleneck"] == "compute"
    fp8 = pm.roofline_seconds(1e12, 1e12, 0.0, n_chips=1, peak_flops=analysis.FP8_FLOP_S)
    assert fp8["bottleneck"] == "memory" and fp8["compute_s"] == 1e12 / analysis.FP8_FLOP_S
    # The same keys as the reference's helper.
    assert r.keys() == jpm.roofline_seconds(1e15, 1e12, 1e10, n_chips=4).keys()
