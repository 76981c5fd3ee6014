"""Names of the reference that this slice's layers lacked, held against the
reference on the CPU: ``kernels/ops.matmul``, ``semiring.pad_value_for`` and
``GemmOp.uses_mxu`` (on the card: "takes a tensor-core schedule", held
against ``plan_gemm``'s choice for each op).

``ops.matmul`` is ``gemm_op`` with the (mul, add) pair, so it keeps
``tests/test_torch_gemm.py``'s bound: 1 ulp of a 16-bit output, 2 ulp of an
fp32 one at the output's largest magnitude (the fp32 sums' order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import precision as jprec  # noqa: E402
from repro.core import semiring as jsemi  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import semiring as tsemi  # noqa: E402
from repro_torch.core.precision import E4M3, FP16  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import redmule_gemm as rg  # noqa: E402


@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8", "tpu_bf16"])
@pytest.mark.parametrize("with_y", [False, True])
def test_matmul_matches_the_reference(policy, with_y):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 13, 70)).astype(np.float32)
    w = rng.standard_normal((70, 29)).astype(np.float32)
    y = rng.standard_normal((13, 29)).astype(np.float32) if with_y else None
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w),
                                  None if y is None else jnp.asarray(y),
                                  policy=jprec.get_policy(policy), backend="xla"))
    got = tops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                      None if y is None else torch.from_numpy(y),
                      policy=tprec.get_policy(policy))
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    w32, g32 = want.astype(np.float32), got.float().numpy()
    scale = np.abs(w32).max()
    if want.dtype.name == "bfloat16":
        ulp = float(2.0 ** (np.floor(np.log2(scale)) - 7))
    else:
        ulp = float(np.spacing(want.dtype.type(scale)))
    limit = (2.0 if want.dtype == np.float32 else 1.0) * ulp
    assert np.abs(g32 - w32).max() <= limit
    # The same function as gemm_op with the (mul, add) pair, bit for bit.
    same = tops.gemm_op(torch.from_numpy(x), torch.from_numpy(w),
                        None if y is None else torch.from_numpy(y), gop=tsemi.MATMUL,
                        policy=tprec.get_policy(policy))
    assert torch.equal(got, same)


@pytest.mark.parametrize("op", [g.name for g in jsemi.TABLE1])
def test_pad_value_for_matches_the_reference(op):
    want = jsemi.pad_value_for(jsemi.get(op))
    got = tsemi.pad_value_for(tsemi.get(op))
    assert got == tuple(float(v) for v in want)


@pytest.mark.parametrize("op", [g.name for g in jsemi.TABLE1])
def test_uses_mxu_matches_the_reference_and_the_plan(op):
    gop = tsemi.get(op)
    assert gop.uses_mxu == jsemi.get(op).uses_mxu
    # An op uses the tensor cores on the card iff plan_gemm puts it there, at
    # every shape band, for fp8 and compute-format operands.
    for dtype, policy in ((E4M3, "redmule_hfp8"), (FP16, "redmule_fp16")):
        for m in (4, 64, 2048):
            x, w = rg.Operand(dtype, m, 512, 512, 1), rg.Operand(dtype, 256, 512, 512, 1)
            plan = rg.plan_gemm(m, 256, 512, 1, x, w, gop, tprec.get_policy(policy))
            assert (plan.schedule in ("tc", "small_row")) == gop.uses_mxu, (dtype, m)


# Names of the reference with no meaning on the card or in torch, each with
# the port's counterpart; ROADMAP.md lists every one.
COUNTERPARTS = {
    "repro.analysis.jaxpr_has_pallas_call": "the serving-step contracts' launch counts",
    "repro.analysis.contracts.jaxpr_has_pallas_call": "the contracts' launch counts",
    "repro.analysis.tiles.ATTN_TABLES": "the Hopper tables of kernels/tuning.py",
    "repro.core.perfmodel.TPU_PEAK_FLOPS_BF16": "roofline/analysis.py's H100 peaks",
    "repro.core.perfmodel.TPU_HBM_BW": "roofline/analysis.py's H100 peaks",
    "repro.core.perfmodel.TPU_ICI_BW": "roofline/analysis.py's H100 peaks",
    "repro.core.perfmodel.TPU_VPU_FLOPS": "roofline/analysis.py's H100 peaks",
    "repro.distrib.compat.set_mesh": "launch/mesh.py's Mesh",
    "repro.distrib.compat.shard_map": "the explicit per-rank bodies",
    "repro.distrib.sharding.P": "the port's spec tuples",
    "repro.models.moe.P": "the port's spec tuples",
    "repro.engine.engine.TPU_BF16": "core.precision.TPU_BF16",
    "repro.kernels.redmule_gemm_pallas": "kernels/redmule_gemm.py::redmule_gemm",
    "repro.kernels.redmule_gemm.redmule_gemm_pallas": "kernels/redmule_gemm.py::redmule_gemm",
    "repro.kernels.flash_attention.paged_flash_decode_pallas":
        "kernels/flash_attention.py::paged_flash_decode",
    "repro.kernels.flash_attention.flash_attention_pallas":
        "kernels/flash_attention.py::flash_attention",
    **{f"repro.kernels.tuning.{n}": "the Hopper plan tables" for n in (
        "clamp_blocks", "heuristic_block_sizes", "autotune_block_sizes", "resolve_block_sizes",
        "autotune_enabled", "clamp_decode_attn_blocks", "decode_attn_blocks",
        "autotune_decode_attn", "LANE", "SUBLANE", "DECODE_ATTN_CANDIDATES",
        "AUTOTUNE_CANDIDATES")},
    **{f"repro.roofline.analysis.{n}": "roofline/cost.py and the H100 peaks" for n in (
        "collective_bytes", "roofline_from_artifacts", "PEAK_FLOPS_BF16", "HBM_BW",
        "ICI_BW_PER_LINK", "ICI_BW_EFFECTIVE")},
    "repro.roofline.hlo_cost": "roofline/cost.py",
    **{f"repro.training.{n}": "the engine core's and generate_static's steps" for n in (
        "make_serve_steps", "make_paged_serve_steps", "make_spec_verify_steps")},
    **{f"repro.training.loop.{n}": "the engine core's and generate_static's steps" for n in (
        "make_serve_steps", "make_paged_serve_steps", "make_spec_verify_steps")},
    "repro.training.loop.resolve_engine": "Engine.with_backend in make_loss_fn",
}


def _public_names(mod) -> list:
    import inspect

    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    own = [n for n, v in vars(mod).items() if not n.startswith("_")
           and (inspect.isfunction(v) or inspect.isclass(v))
           and getattr(v, "__module__", mod.__name__) == mod.__name__]
    return own + [n for n in vars(mod) if not n.startswith("_") and n.isupper()]


def test_every_public_name_of_the_reference_has_its_counterpart():
    """Each public name of each module of ``src/repro/`` (its ``__all__``,
    else its own functions, classes and constants) exists in the port's
    module of the same path, or is a TPU- or JAX-only name that
    :data:`COUNTERPARTS` maps to the port's counterpart and ROADMAP.md
    names. ``repro.launch.dryrun`` sets XLA's device count when imported,
    so its names are read from its source."""
    import ast
    import importlib
    import pkgutil
    import warnings
    from pathlib import Path

    import repro

    root = Path(__file__).resolve().parent.parent
    roadmap = (root / "ROADMAP.md").read_text()
    missing, seen = [], set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for info in pkgutil.walk_packages(repro.__path__, "repro."):
            name = info.name
            if name.endswith("__main__"):
                continue
            port_name = "repro_torch" + name[len("repro"):]
            if name == "repro.launch.dryrun":
                tree = ast.parse((root / "src/repro/launch/dryrun.py").read_text())
                names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
                         and not n.name.startswith("_")]
                port = importlib.import_module(port_name)
            else:
                mod = importlib.import_module(name)
                if name in COUNTERPARTS:
                    seen.add(name)
                    continue
                names = _public_names(mod)
                port = importlib.import_module(port_name)
            for n in names:
                key = f"{name}.{n}"
                if key in COUNTERPARTS:
                    seen.add(key)
                elif not hasattr(port, n):
                    missing.append(key)
    assert not missing, missing
    assert seen == set(COUNTERPARTS), set(COUNTERPARTS) - seen
    for key in COUNTERPARTS:
        assert key.rsplit(".", 1)[-1] in roadmap, key
