"""The port's cell table, input specs and dry run (``configs``,
``models/registry.py``, ``launch/dryrun.py``) against the reference's,
on the CPU; the dry run allocates nothing (the ``meta`` device).

- ``SHAPES``, ``cell_is_runnable``, ``batch_shapes``,
  ``train_input_specs`` and ``decode_input_specs`` equal the reference's
  (shapes and formats; the static cache's leaves layer by layer, the
  reference's stacked units unstacked);
- every arch's ``n_params`` equals the sum over the reference's
  ``jax.eval_shape(model.init)`` leaves, and each rank's parameter bytes
  on the production mesh equal the sum of the reference specs' shard
  shapes;
- ``--all --both-meshes`` ends with every cell ``ok`` or ``skipped``,
  ``skipped`` exactly at ``long_500k`` of the full-attention archs, and
  writes one JSON a cell.
"""
import json
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distrib import sharding as jshd  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402

DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.float8_e4m3fn): torch.float8_e4m3fn,
          jnp.dtype(jnp.float16): torch.float16}


def test_shapes_and_runnable_cells_match_the_reference():
    assert configs.SHAPES == jconfigs.SHAPES
    assert set(configs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    for arch in configs.ARCH_IDS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        for shape in configs.SHAPES:
            assert configs.cell_is_runnable(cfg, shape) == jconfigs.cell_is_runnable(jcfg, shape)
            assert registry.batch_shapes(cfg, shape) == jreg.batch_shapes(jcfg, shape)


def _same(spec, jspec):
    assert tuple(spec.shape) == tuple(jspec.shape)
    assert spec.dtype == DTYPES[jnp.dtype(jspec.dtype)]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for batch, seq in ((2, 64), (3, 256)):
        got, want = registry.train_input_specs(cfg, batch, seq), jreg.train_input_specs(
            jcfg, batch, seq)
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    got = registry.decode_input_specs(cfg, 2, 32)
    want = jreg.decode_input_specs(jcfg, 2, 32)
    _same(got["tokens"], want["tokens"])
    layers = got["cache"]["layers"]
    p = len(cfg.block_pattern)
    n_units = cfg.n_layers // p
    flat = jax.tree_util.tree_flatten_with_path(want["cache"])[0]
    for path, leaf in flat:
        ps = jshd._path_str(path)
        m = re.match(r"(units/b(\d+)|rem/r(\d+))/(attn/)?(.*)$", ps)
        if m is None:
            continue  # pos and enc_pos: the port keeps its own counters
        rest = m.group(5).split("/")
        if m.group(2) is not None:
            idx = [u * p + int(m.group(2)) for u in range(n_units)]
            shape = leaf.shape[1:]
        else:
            idx = [n_units * p + int(m.group(3))]
            shape = leaf.shape
        for i in idx:
            node = layers[i]
            for k in rest:
                node = node[k]
            if rest[-1] in ("index", "pos"):
                # The ring's positions: the port keeps them in int64 (and
                # its write index as a host integer).
                assert rest[-1] == "index" or tuple(node.shape) == tuple(shape)
                continue
            _same(node, jax.ShapeDtypeStruct(shape, leaf.dtype))


def _ref_param_bytes(jcfg, mesh_shape):
    """Bytes of every leaf's shard under the reference's specs."""
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.PRNGKey(0)))
    specs = jshd.param_specs(shapes, jcfg, mesh_shape["model"])
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(shapes),
                          jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))):
        n = 1
        for dim, part in zip(leaf.shape, tuple(spec) + (None,) * (len(leaf.shape) - len(spec))):
            n *= dim // (mesh_shape[part] if part else 1)
        total += n * jnp.dtype(leaf.dtype).itemsize
    n_params = sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(shapes))
    return total, n_params


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_n_params_and_rank_bytes_match_the_reference(arch):
    mesh = make_production_mesh()
    plan, meta = dryrun.lower_cell(arch, "train_4k", mesh)
    want_bytes, want_n = _ref_param_bytes(jconfigs.get_config(arch), mesh.shape)
    assert meta["n_params"] == want_n
    from repro_torch.distrib import sharding as shd

    assert shd.bytes_per_rank(plan["params"], plan["pspecs"], mesh) == want_bytes


def test_dry_run_all_cells_both_meshes(tmp_path, capsys):
    assert dryrun.main(["--all", "--both-meshes", "--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 * len(configs.ARCH_IDS) * len(configs.SHAPES)
    for arch in configs.ARCH_IDS:
        for shape in configs.SHAPES:
            for pod in ("pod1", "pod2"):
                res = json.loads((tmp_path / f"{arch}__{shape}__{pod}.json").read_text())
                full_attention = not configs.get_config(arch).supports_500k
                if shape == "long_500k" and full_attention:
                    assert res["status"] == "skipped"
                    continue
                assert res["status"] == "ok", (arch, shape, pod, res.get("error"))
                assert res["n_chips"] == (512 if pod == "pod2" else 256)
                r = res["roofline"]
                assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
                assert r["bottleneck"] in ("compute", "memory", "collective")
                assert res["memory"]["param_bytes"] > 0
                if res["kind"] == "train":
                    assert res["collectives"]["dp_grad_all_reduce"] > 0
                    assert res["memory"]["moment_bytes"] > 0
    assert sum("[skipped]" in line for line in lines) == 2 * sum(
        not configs.get_config(a).supports_500k for a in configs.ARCH_IDS)
    assert all(line.startswith(("[ok     ]", "[skipped]")) for line in lines)


def test_counts_are_the_direct_runs_at_cut_depth():
    """The depth, batch, prefill-length and sLSTM extrapolation against the
    step run directly at a cut depth (the counts are exact in every kernel's calls,
    operations and bytes), and the dry run's parameter tree against the
    meta model's own ``init``."""
    import dataclasses

    for arch, over, kind, b, s in (("granite-3-8b", dict(n_layers=3), "train", 3, 256),
                                   ("seamless-m4t-large-v2",
                                    dict(n_layers=3, n_encoder_layers=2), "train", 3, 256),
                                   ("internvl2-76b", dict(n_layers=2), "prefill", 3, 128),
                                   ("gemma2-2b", dict(n_layers=2), "prefill", 2, 8192),
                                   ("seamless-m4t-large-v2",
                                    dict(n_layers=1, n_encoder_layers=1), "prefill", 1, 8192),
                                   ("xlstm-125m", dict(n_layers=2), "prefill", 2, 256),
                                   ("recurrentgemma-2b", dict(n_layers=5), "decode", 3, 64)):
        cfg = dataclasses.replace(configs.get_config(arch), **over)
        direct = dryrun._run_step(cfg, kind, b, s, None)
        got = dryrun.step_counts(cfg, kind, b, s)
        assert got.calls == direct.calls, arch
        np.testing.assert_allclose([got.flops, got.bytes], [direct.flops, direct.bytes],
                                   rtol=1e-12)
        from repro_torch.distrib import sharding as shd
        from repro_torch.models import build

        tree = dryrun.meta_params(cfg)
        own = build(cfg, device="meta", backend="torch").init(0)
        assert [(p, tuple(t.shape), t.dtype, t.stride()) for p, t in shd.leaf_paths(tree)] == [
            (p, tuple(t.shape), t.dtype, t.stride()) for p, t in shd.leaf_paths(own)]
