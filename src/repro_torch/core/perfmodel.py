"""Analytic RedMulE performance/energy model (paper Sec. 5, Figs 7/11, Table 2),
the counterpart of ``repro.core.perfmodel``: the cycle and energy model
below is the reference's, value for value; :func:`roofline_seconds` uses the
H100 peaks of ``repro_torch.roofline.analysis``.

The paper evaluates silicon; these models run on no RedMulE, so the *hardware*
claims are reproduced with a first-principles cycle model calibrated against
the paper's published measurement points. Every calibration constant carries
its provenance. The model reproduces:

  - cycle counts / utilization vs (M, N, K)  [Fig. 7a, Fig. 11]
  - sensitivity to the L, H, P design parameters  [Fig. 7b]
  - GFLOPS and GFLOPS/W at the two operating points  [Table 2]
  - speedups vs the 8-core RISC-V software baseline  [Figs 7a, 8, 9, 14]

Matrix convention follows the paper: X is (M, N), W is (N, K), Z/Y are (M, K)
— N is the reduction dimension.
"""
from __future__ import annotations

import dataclasses

# ----------------------------------------------------------------------------
# Hardware description
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RedmuleInstance:
    """One RedMulE instantiation (design-time parameters, paper Fig. 3c)."""

    L: int = 12  # rows of CEs
    H: int = 4  # columns of CEs
    P: int = 3  # pipeline registers per CE
    mem_port_bits: int = 256  # usable HCI shallow-port width (288 = 256+32)
    elem_bits: int = 16  # storage element width (8 for the FP8 instance)

    @property
    def tile_cols(self) -> int:
        """H*(P+1): column extent of one datapath tile (paper Sec. 4.3)."""
        return self.H * (self.P + 1)

    @property
    def n_ce(self) -> int:
        return self.L * self.H

    @property
    def elems_per_cycle(self) -> int:
        return self.mem_port_bits // self.elem_bits


# Paper instances: 12x4 FP16 and 12x8 FP8 share the 288-bit port (Sec. 5.2.3).
REDMULE_12x4_FP16 = RedmuleInstance(L=12, H=4, P=3, elem_bits=16)
REDMULE_12x8_FP8 = RedmuleInstance(L=12, H=8, P=3, elem_bits=8)

# Calibration constants --------------------------------------------------------
# STARTUP: pipeline fill + first buffer preload. Calibrated with Z_DRAIN so the
# model yields 99.4% utilization on 96x96x96 FP16 (paper Sec. 5.2.1).
STARTUP_CYCLES = 16
# Z-buffer drain/reload bubble per output tile (store interleave, Fig. 6c).
Z_DRAIN_CYCLES = 2

# Software baseline: 8 RISC-V cores, 4 shared FPUs (paper Sec. 5.2.1).
# 95.4/15 : paper reports 15x average RedMulE speedup on large FP16 GEMMs.
SW_OPS_PER_CYCLE_GEMM = 95.4 / 15.0
# Group-1 / Group-2 GEMM-Ops hit 47x / 62x (Sec. 5.7): min/max in SW cost
# extra compare-select sequences on the cores.
SW_OPS_PER_CYCLE_G1 = 95.4 / 47.0
SW_OPS_PER_CYCLE_G2 = 95.4 / 62.0
# Parallel-launch/synchronization overhead; calibrated on the paper's 8x8x8
# point (3.5x speedup, Sec. 5.2.1).
SW_LAUNCH_OVERHEAD = 128.0
# INT8 SIMD software (Fig. 9 transformer baseline runs INT8 on the cores):
# 8 cores x sdotp4 (4 MAC = 8 OPs/cycle/core ideal) = 64 OPs/cycle peak;
# ~80% realized, calibrated against Fig. 9's ~4x average RedMulE speedup.
SW_OPS_PER_CYCLE_INT8 = 52.0

# Operating points (paper abstract / Table 2).
FREQ_EFF_HZ = 470e6  # 0.65 V best-efficiency point
FREQ_PERF_HZ = 613e6  # 0.80 V best-performance point

# Cluster power (W) during each kernel class, from Sec. 5.5 / 5.7 / Table 2.
POWER_W = {
    # (instance, kind, point) -> watts
    ("12x4", "gemm", "eff"): 59.3e-3,
    ("12x4", "gemm", "perf"): 116e-3,
    ("12x4", "g1", "eff"): 53.2e-3,
    ("12x4", "g1", "perf"): 103e-3,
    ("12x4", "g2", "eff"): 37.6e-3,
    ("12x4", "g2", "perf"): 71.5e-3,
    ("12x8", "gemm", "eff"): 97.5e-3,
    ("12x8", "gemm", "perf"): 193e-3,
    ("12x8", "g1", "eff"): 85.2e-3,
    ("12x8", "g1", "perf"): 168e-3,
    ("12x8", "g2", "eff"): 54e-3,
    ("12x8", "g2", "perf"): 104e-3,
}

# Clock-gating savings during heavy under-utilization (Sec. 5.6): up to 22%
# when rows idle (M << L), up to 37% with column gating as well.
CLOCK_GATE_ROW_MAX = 0.22
CLOCK_GATE_FULL_MAX = 0.37


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GemmCycles:
    cycles: int
    macs: int
    utilization: float  # achieved MACs/cycle over peak L*H
    padded_macs: int  # MACs the padded iteration space executes
    waste: float  # leftover/padding waste fraction


def redmule_cycles(
    M: int, N: int, K: int, inst: RedmuleInstance = REDMULE_12x4_FP16
) -> GemmCycles:
    """Cycle model for Z = X(MxN) @ W(NxK) (+Y) on one RedMulE instance.

    The datapath processes output tiles of L x T (T = H*(P+1)) with the
    reduction dimension consumed T elements per pass; each pass costs
    T*(P+1)*... = L*T*T / (L*H) = T^2/H cycles at full occupancy.
    """
    T = inst.tile_cols
    tiles_m = _ceil_div(M, inst.L)
    tiles_k = _ceil_div(K, T)
    tiles_n = _ceil_div(N, T)
    passes = tiles_m * tiles_k * tiles_n
    cycles_per_pass = (T * T) // inst.H  # = T * (P+1)
    compute = passes * cycles_per_pass
    total = STARTUP_CYCLES + compute + Z_DRAIN_CYCLES * tiles_m * tiles_k
    macs = M * N * K
    padded = (tiles_m * inst.L) * (tiles_n * T) * (tiles_k * T)
    return GemmCycles(
        cycles=total,
        macs=macs,
        utilization=macs / (total * inst.n_ce),
        padded_macs=padded,
        waste=1.0 - macs / padded,
    )


def sw_cycles(M: int, N: int, K: int, kind: str = "gemm") -> float:
    """8-core RISC-V parallel software baseline (calibrated, see constants)."""
    ops = 2.0 * M * N * K
    rate = {
        "gemm": SW_OPS_PER_CYCLE_GEMM,
        "g1": SW_OPS_PER_CYCLE_G1,
        "g2": SW_OPS_PER_CYCLE_G2,
        "int8": SW_OPS_PER_CYCLE_INT8,
    }[kind]
    return ops / rate + SW_LAUNCH_OVERHEAD


def gflops(M: int, N: int, K: int, inst=REDMULE_12x4_FP16, freq_hz: float = FREQ_PERF_HZ) -> float:
    c = redmule_cycles(M, N, K, inst)
    return 2.0 * c.macs / c.cycles * freq_hz / 1e9


def gflops_per_watt(
    M: int,
    N: int,
    K: int,
    inst=REDMULE_12x4_FP16,
    kind: str = "gemm",
    point: str = "eff",
) -> float:
    name = "12x4" if inst.elem_bits == 16 else "12x8"
    freq = FREQ_EFF_HZ if point == "eff" else FREQ_PERF_HZ
    p = POWER_W[(name, kind, point)]
    return gflops(M, N, K, inst, freq) / p


def clock_gating_power_factor(M: int, N: int, K: int, inst=REDMULE_12x4_FP16) -> float:
    """Fraction of nominal power consumed, with fine-grained gating (Fig. 11).

    Row gating engages when M leaves rows idle; column gating engages on
    N/K leftovers. Savings saturate at the paper's measured 22% / 37%.
    """
    T = inst.tile_cols
    m_left = M % inst.L or inst.L
    rows_active = m_left / inst.L if M < inst.L else 1.0 - (1.0 - m_left / inst.L) / _ceil_div(M, inst.L)
    k_left = K % T or T
    cols_active = k_left / T if K < T else 1.0 - (1.0 - k_left / T) / _ceil_div(K, T)
    row_saving = CLOCK_GATE_ROW_MAX * (1.0 - rows_active)
    col_saving = (CLOCK_GATE_FULL_MAX - CLOCK_GATE_ROW_MAX) * (1.0 - cols_active)
    return 1.0 - min(CLOCK_GATE_FULL_MAX, row_saving + col_saving)


# ----------------------------------------------------------------------------
# Roofline on the port's card: the H100 peaks of repro_torch.roofline.analysis.
# ----------------------------------------------------------------------------


def roofline_seconds(
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    n_chips: int,
    peak_flops: float | None = None,
) -> dict:
    """The three roofline terms on ``n_chips`` H100s: operations at
    ``peak_flops`` (default the fp16/bf16 tensor-core peak), bytes at the
    HBM rate, collective bytes at one direction of each card's NVLink."""
    from repro_torch.roofline import analysis

    peak = analysis.FP16_FLOP_S if peak_flops is None else peak_flops
    compute_t = hlo_flops / (n_chips * peak)
    memory_t = hlo_bytes / (n_chips * analysis.HBM_BYTES_S)
    coll_t = collective_bytes / (n_chips * analysis.NVLINK_BYTES_S)
    terms = {"compute_s": compute_t, "memory_s": memory_t, "collective_s": coll_t}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    return terms
