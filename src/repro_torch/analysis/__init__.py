"""repro_torch.analysis — the port's static contract checking, the counterpart
of ``repro.analysis``.

Three independent passes, one CLI (``python -m repro_torch.analysis``):

- :mod:`repro_torch.analysis.rules` — AST lint rules (``RPR1xx``), the
  reference's catalogue in torch idiom: mutable defaults and shared
  import-time config instances, module-level mutable state in
  ``serving/``, bare ``assert`` in library code, ``torch.from_numpy`` /
  ``as_tensor`` / ``asarray`` over a live numpy mirror without ``.copy()``,
  and host syncs (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``synchronize``, ``float()``/``int()``) inside registered hot paths.
- :mod:`repro_torch.analysis.contracts` — serving-step contracts: every
  decoder-only arch's prefill, decode, verify and batched-prefill steps
  run at fixed shapes, preserve the pools, launch the CUDA kernels iff the
  engine's backend is ``"cuda"``, keep fp8 KV pools in E4M3 under an
  fp32-accumulating policy, and stay within the ``P_BUCKETS`` signature
  bound; on the card the decode and verify steps replay as CUDA graphs
  with the eager step's logits.
- :mod:`repro_torch.analysis.tiles` — static validation of every
  ``kernels/tuning.py`` plan table against the Hopper kernels' limits
  (shared memory, K steps, grids, the ``csrc/`` constants) without running
  a kernel.

Findings are suppressed per line with ``# repro: allow[RPRnnn] <reason>``;
the reason is mandatory — an unexplained pragma is itself a finding.
"""
from repro_torch.analysis.contracts import (
    ContractViolation,
    check_arch,
    check_bucket_policy,
    check_zoo,
    launch_counts,
)
from repro_torch.analysis.rules import (
    HOT_PATHS,
    RULES,
    Finding,
    lint_paths,
    lint_source,
)
from repro_torch.analysis.tiles import TileFinding, validate_tuning_tables

__all__ = [
    "ContractViolation",
    "Finding",
    "HOT_PATHS",
    "RULES",
    "TileFinding",
    "check_arch",
    "check_bucket_policy",
    "check_zoo",
    "launch_counts",
    "lint_paths",
    "lint_source",
    "validate_tuning_tables",
]
