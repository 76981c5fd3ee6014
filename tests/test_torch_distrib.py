"""The port's meshes, sharding rules and fault hooks
(``launch/mesh.py``, ``distrib/sharding.py``, ``distrib/fault.py``)
against the reference's, on the CPU; nothing is allocated.

The parity that counts: for every leaf of every arch at full width, the
piece the reference's ``param_specs`` gives each rank, carried across by
``convert`` (the reference stacks its units on a leading axis, the port
keeps a list of layers; MoE ``up``/``gate`` (E, d, f) become (d, E*f) and
``down`` (E, f, d) becomes (E*f, d)), is the piece the port's spec gives
the same rank, at tp in {1, 2, 4, 8, 16} and on the 16 x 16 production
mesh. Shapes come from ``jax.eval_shape`` on the reference's side and
the ``meta`` device on the port's.
"""
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS, get_config as jget_config  # noqa: E402
from repro.distrib import fault as jfault  # noqa: E402
from repro.distrib import sharding as jshd  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import decode_input_specs as jdecode_input_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distrib import fault, sharding as shd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build, decode_input_specs  # noqa: E402

TP_SIZES = (1, 2, 4, 8, 16)


def _ref_leaves(tree):
    """(path, leaf) of a reference tree, paths as the reference's rules read
    them."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jshd._path_str(p), leaf) for p, leaf in flat]


def _port_path(path: str, cfg) -> list:
    """The port's path(s) of a reference path, with the unit index each
    takes (None for an unstacked leaf)."""
    m = re.match(r"(decoder|encoder)/(units/b(\d+)|rem/r(\d+))/(.*)$", path)
    if m is None:
        return [(path, None)]
    stack, rest = m.group(1), m.group(5)
    pattern = tuple(cfg.block_pattern) if stack == "decoder" else ("attn",)
    n_layers = cfg.n_layers if stack == "decoder" else cfg.n_encoder_layers
    n_units = n_layers // len(pattern)
    name = "layers" if stack == "decoder" else "encoder"
    if m.group(3) is not None:
        j = int(m.group(3))
        return [(f"{name}/{u * len(pattern) + j}/{rest}", u) for u in range(n_units)]
    return [(f"{name}/{n_units * len(pattern) + int(m.group(4))}/{rest}", None)]


def _ranges(shape, spec_parts, tp, m):
    """Each dimension's (start, stop) on 'model' rank m."""
    out = []
    for dim, part in zip(shape, tuple(spec_parts) + (None,) * (len(shape) - len(spec_parts))):
        n = tp if part == "model" else 1
        assert dim % n == 0
        c = dim // n
        i = m if part == "model" else 0
        out.append((i * c, i * c + c))
    return tuple(out)


def _carried(path, shape, ranges):
    """The reference's piece carried into the port's layout, or None where
    it is not a block of it."""
    if re.match(r".*moe/(up|gate)$", path):
        (e0, e1), (d0, d1), (f0, f1) = ranges
        e, d, f = shape
        return ((d0, d1), (e0 * f, e1 * f)) if (f0, f1) == (0, f) else None
    if re.match(r".*moe/down$", path):
        (e0, e1), (f0, f1), (d0, d1) = ranges
        e, f, d = shape
        return ((e0 * f, e1 * f), (d0, d1)) if (f0, f1) == (0, f) else None
    return ranges


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_cut_the_same_pieces_as_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshapes = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.PRNGKey(0)))
    params = build(cfg, device="meta", backend="torch").init(0)
    port = dict(shd.leaf_paths(params))
    prod = tmesh.make_production_mesh()
    for tp in TP_SIZES:
        jspecs = dict(_ref_leaves(jshd.param_specs(jshapes, jcfg, tp)))
        pspecs = dict(zip([p for p, _ in shd.leaf_paths(params)],
                          shd.spec_leaves(shd.param_specs(params, cfg, tp))))
        mesh = tmesh.make_mesh((tp,), ("model",))
        seen = set()
        for rpath, leaf in _ref_leaves(jshapes):
            for ppath, unit in _port_path(rpath, cfg):
                spec = tuple(jspecs[rpath])
                shape = leaf.shape
                if unit is not None or re.match(r".*/units/", rpath):
                    assert spec[0] is None  # the stacked axis is never split
                    spec, shape = spec[1:], shape[1:]
                assert ppath in port, (arch, ppath)
                seen.add(ppath)
                for m in range(tp):
                    want = _carried(rpath, shape, _ranges(shape, spec, tp, m))
                    got = shd.piece_slices(port[ppath].shape, pspecs[ppath], mesh, {"model": m})
                    assert got == want, (arch, tp, ppath, m, spec, pspecs[ppath])
                    if tp == 16 and m in (0, 15):  # the production mesh: 'data' replicates
                        for data in (0, 15):
                            assert shd.piece_slices(port[ppath].shape, pspecs[ppath], prod,
                                                    {"data": data, "model": m}) == want
        assert seen == set(port), (arch, set(port) - seen)


def test_every_full_width_param_tree_is_the_references_size():
    for arch in ARCH_IDS:
        jshapes = jax.eval_shape(lambda: jbuild(jget_config(arch)).init(jax.random.PRNGKey(0)))
        want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jshapes))
        params = build(get_config(arch), device="meta", backend="torch").init(0)
        assert sum(t.numel() for _, t in shd.leaf_paths(params)) == want, arch


def _norm(spec) -> tuple:
    """A spec with one-name tuples written as the name (a PartitionSpec
    keeps either)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


def test_zero1_fsdp_and_batch_specs_match_the_reference():
    # The reference test's case (tests/test_multidevice.py).
    shapes = {"w": torch.empty((64, 32), device="meta"), "v": torch.empty((7, 3), device="meta")}
    z = shd.zero1_specs({"w": (None, "model"), "v": (None, None)}, shapes, ("data",), 8)
    assert z == {"w": (("data",), "model"), "v": (None, None)}
    assert shd.zero1_specs(z, shapes, ("data",), 8) == z  # idempotent
    jz = jshd.zero1_specs({"w": P(None, "model"), "v": P(None, None)},
                          {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
                           for k, v in shapes.items()}, ("data",), 8)
    assert {k: _norm(v) for k, v in jz.items()} == {k: _norm(v) for k, v in z.items()}
    # fsdp and batch specs on a few shapes, against the reference's.
    for shape in ((64, 32), (7, 3), (512,), (3, 256, 64), (16, 16)):
        t = {"x": torch.empty(shape, device="meta")}
        j = {"x": jax.ShapeDtypeStruct(shape, jnp.float32)}
        for axes, n in ((("data", "model"), 16), (("pod", "data", "model"), 32)):
            assert _norm(shd.fsdp_param_specs(t, axes, n)["x"]) == _norm(
                jshd.fsdp_param_specs(j, axes, n)["x"])
        assert _norm(shd.batch_specs(t, ("pod", "data"))["x"]) == _norm(
            jshd.batch_specs(j, ("pod", "data"))["x"])


@pytest.mark.parametrize("arch", ["granite-3-8b", "chatglm3-6b", "recurrentgemma-2b",
                                  "xlstm-125m", "seamless-m4t-large-v2"])
def test_cache_specs_match_the_reference(arch):
    """KV heads over 'model' where they divide (granite at tp 4), else the
    KV sequence (chatglm's 2 KV heads at tp 4; recurrentgemma's MQA);
    state rows over the batch; the batch over the data axes only where it
    divides (batch 8 over 2, and batch 3 not)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for batch, n_dp in ((8, 2), (3, 2)):
        jcache = jdecode_input_specs(jcfg, batch, 64)["cache"]
        jspecs = dict(_ref_leaves(jshd.cache_specs(jcache, jcfg, ("data",), 4, batch, n_dp)))
        cache = decode_input_specs(cfg, batch, 64)["cache"]
        pspecs = dict(zip([p for p, _ in shd.leaf_paths(cache)],
                          shd.spec_leaves(shd.cache_specs(cache, cfg, ("data",), 4, batch, n_dp))))
        for rpath, spec in jspecs.items():
            rp = rpath.replace("/attn/", "/")
            for ppath, unit in _port_path(("decoder/" + rp) if "/" in rp else rp, cfg):
                ppath = ppath.replace("decoder/", "")
                want = tuple(spec)[1:] if re.match(r"units/", rpath) else tuple(spec)
                assert _norm(pspecs[ppath]) == _norm(want), (arch, batch, ppath, want)


def test_mesh_helpers_match_the_reference():
    for multi in (False, True):
        m = tmesh.make_production_mesh(multi_pod=multi)
        assert m.axis_names == (("pod",) if multi else ()) + ("data", "model")
        assert tmesh.dp_axes_of(m) == m.axis_names[:-1]
        assert tmesh.tp_size_of(m) == 16 and tmesh.n_dp_of(m) == (32 if multi else 16)
    jm = jmesh.make_test_mesh((1, 1))
    m = tmesh.make_test_mesh((1, 1))
    assert (tmesh.dp_axes_of(m), tmesh.tp_size_of(m), tmesh.n_dp_of(m)) == (
        jmesh.dp_axes_of(jm), jmesh.tp_size_of(jm), jmesh.n_dp_of(jm))
    m = tmesh.make_mesh((2, 3, 4), ("pod", "data", "model"), rank=17)
    assert m.coords == {"pod": 1, "data": 1, "model": 1} and m.size == 24
    assert m.axis_index(("pod", "data")) == 4 and m.axis_index("model") == 1
    assert m.group_ranks("model") == [16, 17, 18, 19]
    assert m.group_ranks(("pod", "data")) == [1, 5, 9, 13, 17, 21]
    with pytest.raises(RuntimeError, match="no process group"):
        m.group("model")  # an abstract mesh runs no collective
    assert tmesh.make_mesh((1, 1), ("data", "model")).group("model") is None
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 2), ("data", "model"), rank=4)


def test_fault_hooks_match_the_reference(tmp_path):
    flags = {}
    for mod, d in ((jfault, tmp_path / "ref"), (fault, tmp_path / "port")):
        hb = mod.Heartbeat(str(d), host_index=1, interval_s=0.0)
        hb.beat(3)
        assert hb.stale_hosts(3, timeout_s=60.0) == [0, 2]
        assert open(hb.path()).read().split()[0] == "3"
        mon = mod.StragglerMonitor()
        flags[mod] = [mon.record(t) for t in (1.0, 1.0, 10.0, 1.0, 2.5)]
        flags[mod] += [mon.record(3.0, fleet_median_s=1.0), mon.record(1.5, fleet_median_s=1.0)]
    assert flags[fault] == flags[jfault]
    assert flags[fault][2] and flags[fault][5] and not flags[fault][3] and not flags[fault][6]
    slow = fault.Heartbeat(str(tmp_path / "slow"), 0, interval_s=3600.0)
    slow.beat(1)
    t = time.time()
    slow.beat(2)  # within the interval: not written again
    assert open(slow.path()).read().split()[0] == "1" and time.time() - t < 1.0
