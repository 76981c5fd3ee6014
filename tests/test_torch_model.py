"""The port's dense decoder against the JAX package's, on the CPU.

Parameters come from the reference's ``Transformer.init`` on granite
SMOKE, copied across with ``params_from_jax``. The port runs its plain
backend. Its two decode paths are each held against the reference
backend with the same semantics: the gathered decode (engine GEMMs for
the scores and values) against the reference's XLA backend, and the
paged flash-decode attention (``fused_decode``, the kernel's plain
version) against the reference's Pallas kernel path in interpret mode.
Under an fp8 policy the two paths differ by design, in both packages:
the gathered path rounds q and the probabilities to E4M3 in its engine
GEMMs, the paged attention computes in fp32.

Logits of a prefill and decode steps are held to 1e-5 of max|logit|
under fp32. Under redmule_hfp8 with E4M3 KV pages the tolerance is 5e-2:
a one-ulp fp16 difference from the order of a sum can move an activation
across an E4M3 rounding boundary (E4M3's ulp is 6% of the value), and
that flip then reaches the logits. On these inputs no such flip happens:
the test of the two decode paths pins both paths bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import build  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

# (policy, kv pages, fp8 params, tolerance, reference backend)
CASES = {
    "fp32": ("fp32", "fp32", False, 1e-5, "xla"),
    "hfp8": ("redmule_hfp8", "e4m3", False, 5e-2, "xla"),
    "hfp8-fp8-params": ("redmule_hfp8", "e4m3", True, 5e-2, "xla"),
    "hfp8-paged-kernel": ("redmule_hfp8", "e4m3", False, 5e-2, "pallas_interpret"),
}


def _models(policy, kv, fp8_params, backend="xla"):
    """The reference on ``backend`` and the port's plain model with the
    decode path of the same semantics."""
    kw = dict(policy=policy, kv_cache_dtype=kv, fp8_params=fp8_params)
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True), backend=backend, **kw)
    tcfg = dataclasses.replace(tget_config("granite-3-8b", smoke=True), **kw)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tmodel = tbuild(tcfg, device="cpu")
    if backend != "xla":
        tmodel = Transformer(tcfg, engine=tmodel.engine, device="cpu", fused_decode=True)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    return model, params, tmodel, tparams


def _rel(a, b):
    a = np.asarray(a, np.float32)
    return float(np.abs(a - b.numpy()).max() / np.abs(a).max())


@pytest.mark.parametrize("fp8_params", [False, True])
def test_params_from_jax_is_bit_exact(fp8_params):
    model, params, tmodel, tparams = _models("redmule_hfp8", "e4m3", fp8_params)
    unit = params["decoder"]["units"]["b0"]
    assert len(tparams["layers"]) == model.cfg.n_layers
    want_dtype = "float8_e4m3fn" if fp8_params else "float16"
    for i, layer in enumerate(tparams["layers"]):
        for name in ("q", "k", "v", "o"):
            w, t = np.asarray(unit["attn"][name]["w"][i]), layer["attn"][name]["w"]
            assert str(t.dtype).removeprefix("torch.") == want_dtype == w.dtype.name
            bits = np.uint8 if w.dtype.itemsize == 1 else np.uint16
            np.testing.assert_array_equal(t.view(torch.uint8 if bits is np.uint8 else torch.int16)
                                          .numpy().view(bits), w.view(bits))
        np.testing.assert_array_equal(layer["norm2"]["scale"].numpy(),
                                      np.asarray(unit["norm2"]["scale"][i]))
    table = np.asarray(params["embed"]["table"]).astype(np.float32)
    np.testing.assert_array_equal(tparams["embed"]["table"].float().numpy(), table)
    # The port's own init makes the same structure and formats.
    own = tmodel.init(0)
    assert own["embed"]["table"].dtype == tparams["embed"]["table"].dtype
    assert own["layers"][0]["ffn"]["down"]["w"].shape == tparams["layers"][0]["ffn"]["down"]["w"].shape


def _prefill_and_decode(model, params, tmodel, tparams, feed=None):
    """One prefill of 7 tokens in slot 0 and three decode steps with slot 1
    inactive, on the reference and on the port. Decode step i is fed
    ``feed[i]`` when given, else the reference's greedy token. Returns
    the pairs (reference logits, port logits) of slot 0, prefill first."""
    ps, n_pages = 4, 13
    pools = model.init_state_store(2, n_pages, ps)
    tpools = tmodel.init_state_store(2, n_pages, ps)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab_size, (1, 8)).astype(np.int32)
    page_row = np.array([1, 2, 3, 0, 0, 0], np.int32)
    want, pools = model.prefill_cb(params, jnp.asarray(toks), pools, jnp.asarray(page_row),
                                   jnp.int32(0), jnp.int32(0), jnp.int32(7), page_size=ps)
    with torch.inference_mode():
        got = tmodel.prefill_cb(tparams, torch.from_numpy(toks), tpools,
                                torch.from_numpy(page_row), 0, 0, 7, page_size=ps)
    assert got.shape == (1, model.cfg.vocab_size)
    pairs = [(np.asarray(want)[0], got[0].numpy())]

    pt = np.zeros((2, 6), np.int32)
    pt[0, :3] = [1, 2, 3]
    lens = np.array([7, 0], np.int32)
    active = np.array([True, False])
    tok = np.array([[5], [0]], np.int32)
    for i in range(3):
        want, pools = model.decode_cb(params, jnp.asarray(tok), pools, jnp.asarray(pt),
                                      jnp.asarray(lens), jnp.asarray(active), page_size=ps)
        with torch.inference_mode():
            got = tmodel.decode_cb(tparams, torch.from_numpy(tok), tpools, torch.from_numpy(pt),
                                   torch.from_numpy(lens), torch.from_numpy(active),
                                   page_size=ps)
        pairs.append((np.asarray(want)[0], got[0].numpy()))
        nxt = int(np.argmax(pairs[-1][0])) if feed is None else feed[i]
        tok = np.array([[nxt], [0]], np.int32)
        lens = lens + active
    return pairs


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_logits_match_reference(case):
    policy, kv, fp8_params, tol, backend = CASES[case]
    for want, got in _prefill_and_decode(*_models(policy, kv, fp8_params, backend)):
        assert np.isfinite(got).all()
        assert _rel(want, torch.from_numpy(got)) <= tol


def test_hfp8_decode_paths_differ_as_in_the_reference():
    """Under redmule_hfp8 with E4M3 pages each of the port's decode paths
    equals the reference path of the same semantics bit for bit (gathered
    decode = XLA backend, paged attention = Pallas kernel), so the port's
    gap between its two paths is the reference's own gap, and that gap is
    large: the gathered path rounds q and the probabilities to E4M3 in its
    engine GEMMs, the paged attention computes in fp32. The prefill, which
    both paths share, has no gap."""
    feed = [17, 23, 31]
    gathered = _prefill_and_decode(*_models("redmule_hfp8", "e4m3", False, "xla"), feed=feed)
    fused = _prefill_and_decode(*_models("redmule_hfp8", "e4m3", False, "pallas_interpret"),
                                feed=feed)
    for (jx, tx), (jp, tp) in zip(gathered, fused):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tp, jp)
    gap = [float(np.abs(jx - jp).max() / np.abs(jx).max())
           for (jx, _), (jp, _) in zip(gathered, fused)]
    assert gap[0] == 0.0
    assert all(0.05 <= g <= 0.2 for g in gap[1:]), gap


def test_fused_decode_on_the_plain_backend_matches_gathered_decode_in_fp32():
    """The paged attention's plain version (the kernel's semantics) and the
    gathered engine path agree under fp32; they differ under fp8 policies
    only by the engine's E4M3 rounding of q and the probabilities."""
    _, _, tmodel, tparams = _models("fp32", "fp32", False)
    fused = Transformer(tmodel.cfg, engine=tmodel.engine, device="cpu", fused_decode=True)
    outs = []
    for model in (tmodel, fused):
        pools = model.init_state_store(2, 9, 4)
        pt = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]], dtype=torch.int32)
        toks = torch.arange(16).reshape(2, 8) % model.cfg.vocab_size
        with torch.inference_mode():
            for slot, n in ((0, 8), (1, 5)):
                model.prefill_cb(tparams, toks[slot:slot + 1], pools, pt[slot], slot, 0, n,
                                 page_size=4)
            outs.append(model.decode_cb(
                tparams, torch.tensor([[3], [4]]), pools, pt,
                torch.tensor([8, 5], dtype=torch.int32), torch.tensor([True, True]),
                page_size=4))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)


def test_fused_decode_flag_is_for_the_plain_backend_only():
    from repro_torch.engine import Engine

    cfg = tget_config("granite-3-8b", smoke=True)
    with pytest.raises(ValueError, match="plain backend"):
        Transformer(cfg, engine=Engine(policy=cfg.policy, backend="cuda"), device="cpu",
                    fused_decode=True)
    assert Transformer(cfg, engine=Engine(policy=cfg.policy, backend="cuda"),
                       device="cpu").fused_decode
    assert not tbuild(cfg, device="cpu").fused_decode
