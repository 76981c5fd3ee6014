"""The encoder-decoder and VLM families of the port against the JAX
package's, on the CPU: seamless-m4t-large-v2 SMOKE (stub audio frames, a
non-causal encoder, cross-attention in every decoder layer, LayerNorm,
ungated gelu) and internvl2-76b SMOKE (stub image patches through
``vis_proj`` ahead of the tokens, GQA, untied head).

Parameters come from the reference's ``init`` through ``params_from_jax``;
tokens, frames and patches are numpy draws from fixed seeds. The
reference runs jitted (its compiled rounding order) on its XLA backend;
the port runs its plain backend. Tolerances, and why:

- LayerNorm, at the smoke width (d 64) and at seamless's (d 1024): under
  fp32 within 1e-6 of max|y| (read: 2e-7), since torch's two means sum in
  another order than XLA's; in fp16 and bf16 bit for bit at d 64, and at
  d 1024 within one ulp of the format on under 0.1% of the elements
  (read: 2e-4 of them in fp16, none in bf16). The last step is one fused
  multiply-add on both sides;
- the encoder, forward, prefill and decode logits and a train step's loss
  and grad norm under fp32: 1e-5 of the max (read: up to 6e-7), the fp32
  bound of the other families' tests;
- the same under redmule_hfp8 with E4M3 KV (cross K/V stored in E4M3 and
  read back at decode): bit for bit. Every engine product is exact and
  both sides round its fp32 sum once to fp16, and the fp32 ulps of the
  norms stay below the 16-bit roundings at these seeds;
- token streams: equal, greedy.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import for_model as jfor_model  # noqa: E402
from repro.models import build  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.serving import generate_static as jgenerate_static  # noqa: E402
from repro.training import TrainState as JTrainState  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serving import generate_static  # noqa: E402
from repro_torch.training import TrainState, make_train_step  # noqa: E402

ARCHS = ["seamless-m4t-large-v2", "internvl2-76b"]
KW = {"fp32": dict(policy="fp32", kv_cache_dtype="fp32"),
      "redmule_hfp8": dict(policy="redmule_hfp8", kv_cache_dtype="e4m3")}
TOL = {"fp32": 1e-5, "redmule_hfp8": 0.0}
B, S = 2, 8


@functools.lru_cache(maxsize=None)
def _pair(arch, policy="fp32"):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **KW[policy])
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), **KW[policy])
    tmodel = Transformer(tcfg, engine=Engine(policy=policy, backend="torch"), device="cpu")
    return model, params, tmodel, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


def _batch(cfg, seed=0, b=B, s=S):
    """Tokens and the family's stub frontend, as the data pipeline draws
    them (fp16 frames of ``s * enc_dec_ratio``, fp16 patches)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((b, s * cfg.enc_dec_ratio, cfg.d_model),
                                            dtype=np.float32).astype(np.float16)
    if cfg.family == "vlm":
        out["vis_embeds"] = rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model),
                                                dtype=np.float32).astype(np.float16)
    return out


def _t(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _rel(want, got) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


# -- LayerNorm ------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_layernorm_matches_the_compiled_reference(dtype):
    rng = np.random.default_rng(1)
    fn = jax.jit(lambda p, x: jcommon.norm_apply(p, x, "layernorm"))
    for d in (64, 1024):
        x = (rng.standard_normal((4, 16, d)) * 3 + 0.5).astype(np.float32)
        p = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
             "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
        want = fn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x).astype(dtype))
        got = common.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x).to(getattr(torch, dtype)), "layernorm")
        assert got.dtype == getattr(torch, dtype)
        want = np.asarray(want.astype(jnp.float32))
        diff = np.abs(got.float().numpy() - want)
        if dtype == "float32":
            assert diff.max() <= 1e-6 * np.abs(want).max(), d
            continue
        if d == 64:
            assert diff.max() == 0
        # Steps between the two in the format's own encoding (one sign here).
        steps = (got.view(torch.int16).int()
                 - torch.tensor(want).to(got.dtype).view(torch.int16).int()).abs()
        assert int(steps.max()) <= 1 and float((steps > 0).float().mean()) < 1e-3, d
    assert common.norm_init(8, "cpu", "layernorm").keys() == {"scale", "bias"}


# -- the model --------------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8"])
def test_encoder_matches_reference(policy):
    """seamless's encoder: ``enc_proj`` on the frames, the non-causal
    layers (a query sees keys after it) and ``enc_final_norm``."""
    model, params, tmodel, tparams = _pair("seamless-m4t-large-v2", policy)
    frames = _batch(model.cfg)["frames"]
    want, wpos = jax.jit(lambda p, f: model._encode(p, f, model.engine))(params, frames)
    with torch.inference_mode():
        got, pos = tmodel._encode(tparams, torch.from_numpy(frames), tmodel.engine)
    assert got.shape == want.shape == (B, S * 4, 64)
    assert _rel(want, got) <= TOL[policy]
    assert pos.tolist() == np.asarray(wpos).tolist()


@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, policy):
    """Teacher-forced logits of the tokens (the VLM's patches dropped)."""
    model, params, tmodel, tparams = _pair(arch, policy)
    batch = _batch(model.cfg)
    h, _ = jax.jit(model.forward)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jax.jit(model.logits)(params, h)
    with torch.inference_mode():
        th, aux = tmodel.forward(tparams, _t(batch))
        got = tmodel.logits(tparams, th)
    assert got.shape == want.shape == (B, S, model.cfg.vocab_size)
    assert _rel(want, got) <= TOL[policy] and float(aux) == 0.0


@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch, policy):
    """``prefill`` of half the tokens and a ``decode_step`` for each of the
    rest, the cache sized as the reference's ``tests/test_decode.py`` sizes
    it (the VLM's patches counted, seamless's cross K/V of its frames):
    every step's logits against the reference's, and under fp32 against
    the teacher-forced forward too. Under redmule_hfp8 the cross K/V are
    stored in E4M3: the prefill attends over the unrounded values, the
    decode steps over the stored ones, on both sides."""
    model, params, tmodel, tparams = _pair(arch, policy)
    cfg = model.cfg
    batch = _batch(cfg, seed=2)
    toks = batch["tokens"]
    cross = batch["frames"].shape[1] if "frames" in batch else 0
    max_len = S + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    jcache = model.init_cache(B, max_len, cross_len=cross)
    tcache = tmodel.init_cache(B, max_len, cross_len=cross)
    half = S // 2
    pre = dict(batch, tokens=toks[:, :half])
    want, jcache = jax.jit(model.prefill)(params, {k: jnp.asarray(v) for k, v in pre.items()},
                                          jcache)
    decode = jax.jit(model.decode_step)
    with torch.inference_mode():
        got = tmodel.prefill(tparams, _t(pre), tcache)
        assert _rel(want, got) <= TOL[policy]
        if cross:
            assert tcache["layers"][0]["cross_k"].dtype == tmodel.kv_dtype
            assert _rel(jcache["units"]["b0"]["cross_k"][0], tcache["layers"][0]["cross_k"]) \
                <= TOL[policy]
        rows = [got[:, -1]]
        for t in range(half, S):
            want, jcache = decode(params, jnp.asarray(toks[:, t:t + 1]), jcache)
            got = tmodel.decode_step(tparams, torch.from_numpy(toks[:, t:t + 1]).long(), tcache)
            assert _rel(want, got) <= TOL[policy], t
            rows.append(got[:, 0])
        assert tcache["pos"] == max_len
        if policy == "fp32":
            h, _ = tmodel.forward(tparams, _t(batch))
            full = tmodel.logits(tparams, h)
            for i, row in enumerate(rows):
                assert _rel(full[:, half - 1 + i].numpy(), row) <= TOL[policy]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One AdamW step on the data pipeline's batch (seamless: 16 frames,
    4 decoder tokens, the ``seq // enc_dec_ratio`` rule reaching the loss;
    internvl2: 8 patches ahead of 16 tokens): loss and grad norm within
    1e-5, and every parameter after the update within 5e-5. Adam's first
    step moves a parameter by about lr * g / (|g| + eps) = lr, whatever
    |g|, so where a gradient is near eps its fp32 ulps move the step by a
    share of lr (read: 2.3e-5 on one element of seamless's 1e-3 steps)."""
    model, params, tmodel, tparams = _pair(arch)
    jopt, opt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, jopt.init(params),
                         jnp.zeros((), jnp.int32))
    state = TrainState(0, tparams, opt.init(tparams), 0)
    batch = jfor_model(model.cfg, seq_len=16, global_batch=2).batch(0)
    assert batch["tokens"].shape == ((2, 4) if arch == ARCHS[0] else (2, 16))
    jstate, jm = jax.jit(jmake_train_step(model, jopt))(jstate, batch)
    state, m = make_train_step(tmodel, opt)(state, batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(jm[k]) - float(m[k])) <= 1e-5 * abs(float(jm[k])), k
    want = leaves(params_from_jax(jax.tree.map(np.asarray, jstate.params), tmodel.cfg))
    for w, g in zip(want, leaves(state.params)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=5e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_leaf(arch):
    """Every leaf of the reference's tree reaches the port's (the encoder
    stack, the cross blocks, ``norm_x``, LayerNorm's bias, ``enc_proj``,
    ``enc_final_norm``, ``vis_proj``), element for element, and the tree
    has the structure and shapes of the port's own ``init``."""
    model, params, tmodel, tparams = _pair(arch)
    ref = jax.tree.leaves(params)
    got = leaves(tparams)
    assert sum(t.numel() for t in got) == sum(a.size for a in ref)
    assert sum(float(t.double().abs().sum()) for t in got) == pytest.approx(
        sum(float(np.abs(np.asarray(a, np.float64)).sum()) for a in ref), rel=1e-9)
    own = tmodel.init(0)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(own) == shapes(tparams)
    names = set(tparams) | set(tparams["layers"][0])
    want = ({"encoder", "enc_final_norm", "enc_proj", "cross", "norm_x"} if arch == ARCHS[0]
            else {"vis_proj", "head"})
    assert want <= names
    if arch == ARCHS[0]:
        assert set(tparams["layers"][0]["norm1"]) == {"scale", "bias"}


# -- static serving -------------------------------------------------------------------------

def test_generate_static_keeps_the_image_prefix_the_reference_drops():
    """The reference's ``generate_static`` sizes its ring as tokens + new
    tokens, without internvl2's image prefix, so its decode steps overwrite
    the patches and its greedy chain leaves the teacher-forced one; the
    port's counts the prefix and follows it. Each chain is checked against
    the reference's teacher-forced ``forward`` over the prompt and the
    chain itself."""
    model, params, tmodel, tparams = _pair("internvl2-76b")
    batch = _batch(model.cfg, seed=5, s=6)
    new = 6
    fwd = jax.jit(lambda p, b: model.logits(p, model.forward(p, b)[0]))

    def teacher_forced(chain):
        toks = np.concatenate([batch["tokens"], chain[:, :-1]], axis=1).astype(np.int32)
        logits = fwd(params, dict({k: jnp.asarray(v) for k, v in batch.items()},
                                  tokens=jnp.asarray(toks)))
        return np.asarray(jnp.argmax(logits[:, batch["tokens"].shape[1] - 1:], -1))

    want, _ = jgenerate_static(model, params, {k: jnp.asarray(v) for k, v in batch.items()},
                               max_new_tokens=new)
    got, _ = generate_static(tmodel, tparams, _t(batch), max_new_tokens=new)
    assert not np.array_equal(teacher_forced(np.asarray(want)), np.asarray(want))
    assert np.array_equal(teacher_forced(got), got)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_static_and_train_on_the_cpu(arch, capsys):
    """The serve launcher falls back to static mode for both families and
    passes their stub frontends; the train launcher takes their batches."""
    from repro_torch.launch import serve, train

    server, seqs = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
                               "--prompt-len", "6", "--max-new", "3"])
    assert server is None and seqs.shape == (2, 3)
    out = capsys.readouterr().out
    assert "falling back to --mode static" in out
    assert ("frames (2, 24, 64)" if arch == ARCHS[0] else "vis_embeds (2, 8, 64)") in out
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--seq",
                      "16", "--batch", "2", "--log-every", "1"])
    assert len(res["history"]) == 2 and all(np.isfinite(h["loss"]) for h in res["history"])
