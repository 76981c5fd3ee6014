"""Static validation of the Hopper plan tables in ``kernels/tuning.py``, the
counterpart of ``repro.analysis.tiles``.

The reference checks that its TPU tiles are sublane/lane aligned and fit
VMEM. On the card the tiles are ``constexpr`` in ``csrc/`` and the tables
choose plans, so this module checks, without running a kernel:

- every split rule: positive, each GEMM rule's least K a multiple of its
  kernel's K step, the decode's resident blocks within an SM's threads;
- the band ceilings against the kernels' limits (``SMALL_M_MAX`` rows
  at most the small-row kernel's);
- shared memory per block within the H100's 227 KB for each schedule's
  staged tiles (the tensor cores' TMA stages and fp16 tiles, the small-row
  X stage, the SIMT tiles of each form, the paged decode's buffers at every
  head dim, format and page size swept);
- by sweeping band seams (M = 1, 8, 9, 16, 17, 64, 65, 128, 129, ...)
  through the real selection functions: each schedule in its band, K
  splits in multiples of each kernel's step that leave no split empty,
  grids within 65535 in y and z, and splits that never shrink as M (or the
  decode's slots) thins;
- every small-row plan within the kernel's largest cluster
  (``SR_MAX_CLUSTER``); the K-major copy's tile (its stages within the
  48 KB of static shared memory, eight 16-byte chunks a K row for its
  swizzle, K rows in whole groups of 16);
- the Python mirrors of the ``csrc/`` constants (``TC_TILE_M/N`` against
  ``BM/BN``, ``SR_BLOCK_N``, ``SR_STEP``, ``SR_MAX_M``, ``SR_MAX_CLUSTER``,
  ``COPY_TILE_K/BYTES``, the SIMT tiles,
  ``_DECODE_GROUP`` against ``GB``, the dense attention's query and key
  tiles and padding) equal to the values read from the sources, and each
  dense attention instance's shared memory (tensor cores at hd 64, 128
  and 256; the register-tiled kernel at each width) within a block's.

Coverage is enforced structurally, as in the reference:
:func:`discover_tables` finds every module-level split rule
(``SplitRule``, ``DecodeRule``), and :func:`validate_tuning_tables`
reports a rule the validator does not know.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from repro_torch.core import semiring
from repro_torch.core.precision import E4M3, FP16, FP32, get_policy
from repro_torch.kernels import flash_attention, redmule_gemm, tuning
from repro_torch.kernels._build import CSRC

SMEM_PER_BLOCK = 227 * 1024  # the most shared memory an H100 block can opt into
STATIC_SMEM = 48 * 1024  # the most static shared memory a block declares
MAX_GRID_YZ = 65535
THREADS_PER_SM = 2048
# Band seams of M, and the shapes swept across them.
_SWEEP_M = (1, 2, 4, 8, 9, 15, 16, 17, 20, 32, 63, 64, 65, 127, 128, 129, 256, 512, 2048)
_SWEEP_N = (32, 64, 1024, 12800)
_SWEEP_K = (16, 64, 256, 1000, 4096, 16384)
_SWEEP_BATCH = (1, 8)
# (S slots, KV heads, query heads a KV head, pages a slot) for the decode.
_SWEEP_DECODE = [(s, hkv, g, pages) for s in (1, 2, 4, 16, 64) for hkv in (1, 4, 8)
                 for g in (1, 4, 10) for pages in (1, 7, 64, 313, 4096)]

# The rules this validator knows: each GEMM rule with the K step its least
# K must be a multiple of, and the decode's.
GEMM_TABLES = {"SMALL_ROW_SPLIT": "SR_STEP", "SIMT_SPLIT": "SIMT_BK"}
DECODE_TABLES = ("DECODE_SPLIT",)

# Python mirror -> (csrc file, constant).
MIRRORS = {
    ("redmule_gemm", "TC_TILE_M"): ("redmule_gemm_tc.cu", "BM"),
    ("redmule_gemm", "TC_TILE_N"): ("redmule_gemm_tc.cu", "BN"),
    ("redmule_gemm", "SR_BLOCK_N"): ("redmule_gemm_sr.cu", "SR_BLOCK_N"),
    ("redmule_gemm", "SR_STEP"): ("redmule_gemm_sr.cu", "SR_STEP"),
    ("redmule_gemm", "SR_MAX_M"): ("redmule_gemm_sr.cu", "SR_MAX_M"),
    ("redmule_gemm", "SR_MAX_CLUSTER"): ("redmule_gemm_sr.cu", "SR_MAX_CLUSTER"),
    ("redmule_gemm", "COPY_TILE_K"): ("redmule_gemm_sr.cu", "COPY_TILE_K"),
    ("redmule_gemm", "COPY_TILE_BYTES"): ("redmule_gemm_sr.cu", "COPY_TILE_BYTES"),
    ("redmule_gemm", "SIMT_TILE_M"): ("redmule_simt.cuh", "BM"),
    ("redmule_gemm", "SIMT_TILE_N"): ("redmule_simt.cuh", "BN"),
    ("redmule_gemm", "SIMT_BK"): ("redmule_simt.cuh", "BK"),
    ("flash_attention", "_DECODE_GROUP"): ("paged_decode.cu", "GB"),
    ("flash_attention", "TC_ROWS"): ("flash_attention_tc.cu", "BQ"),
    ("flash_attention", "TC_KEYS"): ("flash_attention_tc.cu", "BKEYS"),
    ("flash_attention", "TC_KEYS_HD256"): ("flash_attention_tc.cu", "BKEYS_HD256"),
    ("flash_attention", "SIMT_KEYS"): ("flash_attention.cu", "BK"),
    ("flash_attention", "SIMT_PAD"): ("flash_attention.cu", "PAD"),
    ("flash_attention", "SIMT_P_ROW"): ("flash_attention.cu", "PK"),
}
_MODULES = {"redmule_gemm": redmule_gemm, "flash_attention": flash_attention}
_CONSTEXPR = re.compile(r"constexpr\s+int\s+([^;(]+);")


@dataclasses.dataclass(frozen=True)
class TileFinding:
    table: str
    entry: str
    detail: str

    def __str__(self) -> str:
        return f"kernels/tuning.py::{self.table}[{self.entry}]: {self.detail}"


def discover_tables(module=tuning) -> list[str]:
    """Module-level split rules: the shape every plan table here has."""
    return sorted(name for name, val in vars(module).items()
                  if isinstance(val, (tuning.SplitRule, tuning.DecodeRule)))


def csrc_constants(path: Path) -> dict[str, int]:
    """The ``constexpr int NAME = <value>`` declarations of one source whose
    value is an integer expression of literals and earlier such constants
    (``SR_XS = SR_CHUNK + 16``); a declaration may hold several."""
    out: dict[str, int] = {}
    for decl in _CONSTEXPR.findall(path.read_text()):
        for part in decl.split(","):
            name, _, expr = part.partition("=")
            value = _int_expr(expr.split("//")[0], out)
            if value is not None:
                out[name.strip()] = value
    return out


def _int_expr(expr: str, known: dict[str, int]) -> int | None:
    tokens = re.findall(r"[A-Za-z_]\w*|\d+|[-+*/()]|\S", expr)
    out = []
    for tok in tokens:
        if tok[0].isalpha() or tok[0] == "_":
            if tok not in known:
                return None
            out.append(str(known[tok]))
        elif tok.isdigit() or tok in "+-*()":
            out.append(tok)
        elif tok == "/":
            out.append("//")
        else:
            return None
    try:
        return int(eval("".join(out), {"__builtins__": {}})) if out else None
    except (SyntaxError, ZeroDivisionError):
        return None


def tc_smem_bytes(c: dict, fp8: bool) -> int:
    """``smem_bytes`` of redmule_gemm_tc.cu: the TMA stages, the fp16 tiles
    the fp8 path widens into, the stage barriers and the alignment pad."""
    stage = c["BM"] * c["BK_BYTES"] + c["BN"] * c["BK_BYTES"]
    if fp8:
        return c["STAGES_8"] * stage + 2 * 2 * stage + 2 * c["STAGES_8"] * 8 + 1024
    return c["STAGES_16"] * stage + 2 * c["STAGES_16"] * 8 + 1024


def sr_smem_bytes(c: dict) -> int:
    """The small-row kernel's staged X: two eight-row halves of SR_XS bytes."""
    return -(-c["SR_MAX_M"] // 8) * 8 * c["SR_XS"]


def copy_smem_bytes(c: dict) -> int:
    """The K-major copy's tile kernel: COPY_STAGES tiles in flight, in
    static shared memory (at most 48 KB a block)."""
    return c["COPY_STAGES"] * c["COPY_TILE_K"] * c["COPY_TILE_BYTES"]


def simt_smem_bytes(c: dict, form: str) -> int:
    """The tiled SIMT forms' raw double buffers and compute tiles
    (redmule_simt.cuh, tile_kernel)."""
    bm, bn, bk, pad = c["BM"], c["BN"], c["BK"], c["PAD"]
    wp = (bn // 2 if form == "h2" else bn) + pad
    return 2 * bm * bk * 4 + 2 * bn * bk * 4 + bk * (bm + pad) * 4 + bk * wp * 4


def decode_smem_bytes(c: dict, hd: int, es: int, page_size: int, pages_per_split: int) -> int:
    """The paged decode's dynamic shared memory (paged_decode.cu, launch)."""
    up16 = lambda x: -(-x // 16) * 16  # noqa: E731
    row = hd * es
    per_step = max(1, min(pages_per_split,
                          flash_attention._DECODE_STEP_BYTES // row // page_size))
    tokens = per_step * page_size
    gb, nb = c["GB"], c["NB"]
    pv_dims = max(hd // 32, 4)
    ntg = c["THREADS"] // (hd // pv_dims)
    off_kv = (up16(gb * hd * 4) + up16(tokens * gb * 4) + up16((3 * gb + 1) * 4)
              + up16(2 * pages_per_split * 4))
    return off_kv + max(2 * nb * up16(tokens * row), ntg * gb * hd * 4)


def validate_tuning_tables(module=tuning, csrc: Path = CSRC) -> list[TileFinding]:
    """Every table entry, the kernels' limits and the selection sweep; an
    empty list is clean."""
    findings: list[TileFinding] = []

    def bad(table, entry, detail):
        findings.append(TileFinding(table, str(entry), detail))

    consts = {name: csrc_constants(csrc / name) for name in
              ("redmule_gemm_tc.cu", "redmule_gemm_sr.cu", "redmule_simt.cuh", "paged_decode.cu",
               "flash_attention_tc.cu", "flash_attention.cu")}

    # -- coverage: no unknown tables -------------------------------------------
    known = set(GEMM_TABLES) | set(DECODE_TABLES)
    for name in discover_tables(module):
        if name not in known:
            bad(name, "*", "table not covered by repro_torch.analysis.tiles: register it in "
                           "GEMM_TABLES/DECODE_TABLES with its rule")

    # -- the Python mirrors of the csrc constants ------------------------------
    for (mod, attr), (src, const) in MIRRORS.items():
        want = consts[src].get(const)
        got = getattr(_MODULES[mod], attr)
        if want is None:
            bad("csrc", f"{src}:{const}", "constant not found in the source")
        elif got != want:
            bad("csrc", f"{mod}.{attr}", f"Python mirror {got} != {src}'s {const} = {want}")

    # -- entries -----------------------------------------------------------------
    for name, step_attr in GEMM_TABLES.items():
        rule = getattr(module, name, None)
        if rule is None:
            bad(name, "*", "rule missing from kernels/tuning.py")
            continue
        step = getattr(redmule_gemm, step_attr)
        if rule.blocks < 1 or rule.min_k < 1:
            bad(name, "*", f"degenerate rule {rule}")
        if rule.min_k % step:
            bad(name, "*", f"least K a split {rule.min_k} is not a multiple of the "
                           f"kernel's K step {step_attr} = {step}")
    for name in DECODE_TABLES:
        rule = getattr(module, name, None)
        if rule is None:
            bad(name, "*", "rule missing from kernels/tuning.py")
            continue
        most = THREADS_PER_SM // consts["paged_decode.cu"]["THREADS"]
        if not 1 <= rule.blocks_per_sm <= most or rule.min_pages < 1:
            bad(name, "*", f"rule {rule} outside 1..{most} resident blocks or below a page")

    # -- bands against the kernels' limits ---------------------------------------
    if not 1 <= module.SMALL_M_MAX <= redmule_gemm.SR_MAX_M:
        bad("SMALL_M_MAX", "*", f"band ceiling {module.SMALL_M_MAX} outside the small-row "
                                f"kernel's 1..{redmule_gemm.SR_MAX_M} rows")
    if module.SIMT_WARP_MAX_OUTPUTS < 1:
        bad("SIMT_WARP_MAX_OUTPUTS", "*", "no output takes the warp form")
    sr = consts["redmule_gemm_sr.cu"]
    # Each block's fp32 partial tile lies over its staged X, one eight-row half.
    if 8 * sr["SR_BLOCK_N"] * 4 > 8 * sr["SR_XS"]:
        bad("smem", "small_row", "the partial tile of eight rows exceeds one staged half")
    if copy_smem_bytes(sr) > STATIC_SMEM:
        bad("smem", "kmajor tile", f"{copy_smem_bytes(sr)} bytes of static shared memory > "
                                   f"{STATIC_SMEM}")
    if sr["COPY_TILE_BYTES"] != 8 * 16 or sr["COPY_TILE_K"] % 16:
        bad("csrc", "COPY_TILE", f"a copy tile of {sr['COPY_TILE_K']} K rows x "
                                 f"{sr['COPY_TILE_BYTES']} bytes: the swizzle wants 8 chunks "
                                 "of 16 bytes a K row and whole groups of 16 K rows")

    # -- shared memory per block ---------------------------------------------------
    tc = consts["redmule_gemm_tc.cu"]
    sizes = {"tc fp8": tc_smem_bytes(tc, True), "tc 16-bit": tc_smem_bytes(tc, False),
             "small_row": sr_smem_bytes(consts["redmule_gemm_sr.cu"])}
    for form in ("f32", "h2"):
        sizes[f"simt {form}"] = simt_smem_bytes(consts["redmule_simt.cuh"], form)
    # The dense attention's instances (their tiles from the mirrors above).
    for hd in flash_attention.TC_HEAD_DIMS:
        sizes[f"flash tc hd {hd}"] = flash_attention.tc_tile(hd)["smem_bytes"]
    for width in flash_attention.SIMT_WIDTHS:
        sizes[f"flash simt hd {width}"] = flash_attention.simt_tile(FP32, width)["smem_bytes"]
    for label, size in sizes.items():
        if size > SMEM_PER_BLOCK:
            bad("smem", label, f"{size} bytes a block > the H100's {SMEM_PER_BLOCK}")
    dec = consts["paged_decode.cu"]
    for hd in (8, 16, 32, 64, 128, 256):
        for es in (1, 2, 4):
            for page_size in (8, 16, 32):
                for s, hkv, g, pages in _SWEEP_DECODE[::7]:
                    groups = -(-g // flash_attention._DECODE_GROUP)
                    splits = module.decode_splits(s, hkv, pages, groups=groups)
                    per = -(-pages // splits)
                    size = decode_smem_bytes(dec, hd, es, page_size, per)
                    if size > SMEM_PER_BLOCK:
                        bad("DECODE_SPLIT", f"{es}-byte KV", f"hd {hd} page {page_size}, {per} pages a "
                                                f"split: {size} bytes a block")

    # -- the selection sweep ------------------------------------------------------
    _sweep_gemm(module, bad)
    _sweep_decode(module, bad)
    return findings


def _operand(dtype, rows, k):
    return redmule_gemm.Operand(dtype, rows, k, k, 1)


def _sweep_gemm(module, bad) -> None:
    rg = redmule_gemm
    cases = [(E4M3, get_policy("redmule_hfp8"), semiring.MATMUL),
             (E4M3, get_policy("redmule_hfp8"), semiring.get("apsp")),
             (FP32, get_policy("fp32"), semiring.MATMUL),
             (FP16, get_policy("redmule_fp16"), semiring.MATMUL),
             (FP16, get_policy("redmule_fp16"), semiring.get("max_capacity_path"))]
    for dtype, policy, gop in cases:
        for n in _SWEEP_N:
            for k in _SWEEP_K:
                for batch in _SWEEP_BATCH:
                    last = None  # (schedule, form, split) at the previous, larger M
                    for m in reversed(_SWEEP_M):
                        entry = f"{gop.name} {str(dtype)[6:]} B{batch} M{m} N{n} K{k}"
                        plan = rg.plan_gemm(m, n, k, batch, _operand(dtype, m, k),
                                            _operand(dtype, n, k), gop, policy)
                        _check_plan(module, bad, entry, plan, m, n, k, batch, dtype, gop)
                        key = (plan.schedule, plan.form)
                        if last is not None and last[0] == key and plan.split < last[1]:
                            bad("plan_gemm", entry, f"split {plan.split} below {last[1]} at "
                                                    "more rows: splits must not shrink as M thins")
                        last = (key, plan.split)


def _check_plan(module, bad, entry, plan, m, n, k, batch, dtype, gop) -> None:
    rg = redmule_gemm
    fp8 = dtype in (E4M3,)
    if fp8 and gop.is_gemm:
        want = "small_row" if m <= module.SMALL_M_MAX else "tc"
        if plan.schedule != want:
            bad("plan_gemm", entry, f"schedule {plan.schedule} in the {want} band")
        if want == "tc" and plan.widen != (m > rg.TC_TILE_M and n > rg.TC_TILE_N):
            bad("plan_gemm", entry, f"widen {plan.widen} against the tile rule")
    if plan.schedule == "small_row" and m > rg.SR_MAX_M:
        bad("plan_gemm", entry, f"small rows for {m} > SR_MAX_M rows")
    if plan.schedule == "small_row" and plan.split > rg.SR_MAX_CLUSTER:
        bad("plan_gemm", entry, f"small-row split {plan.split} over the kernel's cluster "
                                f"cap {rg.SR_MAX_CLUSTER}")
    step = {"small_row": rg.SR_STEP, "simt": rg.SIMT_BK}.get(plan.schedule)
    if plan.split > 1 or plan.schedule != "tc":
        if plan.form == "warp":
            if plan.split != 1 or m * n * batch > module.SIMT_WARP_MAX_OUTPUTS:
                bad("plan_gemm", entry, f"warp form with split {plan.split}, "
                                        f"{m * n * batch} outputs")
        elif step is not None:
            if k and plan.k_per_split % step:
                bad("plan_gemm", entry, f"K a split {plan.k_per_split} not a multiple of "
                                        f"{step}")
            if k and (plan.split - 1) * plan.k_per_split >= k:
                bad("plan_gemm", entry, f"split {plan.split} of {plan.k_per_split} leaves "
                                        "a split empty")
    if plan.schedule == "tc" and plan.split != 1:
        bad("plan_gemm", entry, "the tensor cores split K")
    # Grids: small rows (n tiles, split, batch), SIMT tiles (n tiles x split,
    # m tiles, batch), tensor cores (tiles, 1, batch).
    grid_y = {"small_row": plan.split, "simt": -(-m // rg.SIMT_TILE_M), "tc": 1}[plan.schedule]
    if grid_y > MAX_GRID_YZ or batch > MAX_GRID_YZ:
        bad("plan_gemm", entry, f"grid y {grid_y} or z {batch} over {MAX_GRID_YZ}")


def _sweep_decode(module, bad) -> None:
    for hkv, g, pages in {(h, g, p) for _, h, g, p in _SWEEP_DECODE}:
        groups = -(-g // flash_attention._DECODE_GROUP)
        last = None
        for s in (64, 16, 4, 2, 1):  # fewer slots: splits must not shrink
            splits = module.decode_splits(s, hkv, pages, groups=groups)
            entry = f"S{s} Hkv{hkv} G{g} P{pages}"
            per = -(-pages // splits)
            if not 1 <= splits <= max(pages, 1) or (splits - 1) * per >= max(pages, 1):
                bad("decode_splits", entry, f"{splits} splits of {per} pages leave one empty")
            if splits > MAX_GRID_YZ or hkv * groups > MAX_GRID_YZ:
                bad("decode_splits", entry, "grid y or z over 65535")
            if last is not None and splits < last:
                bad("decode_splits", entry, f"{splits} splits below {last} at more slots")
            last = splits

