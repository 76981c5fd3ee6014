"""The serving launcher's ``--spec-gate``, and the greedy-parity accounting
it applies where parity cannot be bitwise.

On the CPU, and on the card in fp32, greedy speculative output is the
plain greedy chain token for token. On the card under an fp8 policy the
two runs compute the same positions differently: the verify step's
attention runs its two products through the GEMM engine (q and the
probabilities rounded to E4M3, fresh keys in fp16), plain decode runs the
paged-decode kernel in fp32 over E4M3 pages. Their logits differ by a
little, so the tokens can part at a near-tie. :func:`greedy_accounting`
tells such a split from a fault. At a split the plain run preferred its
token over the one the speculative run emitted by a margin; the two
computations moved the margin between the plain row's top two tokens by
some amount at the positions where the runs still agreed. A split whose
margin exceeds the largest such move is unexplained: a wrong token (an
off-by-one, a stale key) fails it.

:func:`record_rows` keeps the logits rows the accounting reads. It wraps
a server instance's steps and is meant for one checked run, not for
serving.
"""
from __future__ import annotations

import torch

from repro_torch.serving import SamplingParams, Server


def record_rows(server, rows: dict) -> None:
    """Keep in ``rows``, keyed (request id, token index), the logits row
    each token after the first was sampled from: the decode step's, or
    the verify step's (a later round's row replaces a row whose draft was
    rejected, so the rows kept are those of the emitted tokens). Wraps
    the server's engine decode dispatch and sampler, or its verifier's
    verify step, on the instance; the first token comes from the prefill
    in both runs and is not kept."""
    if server.verifier is not None:
        verify = server.verifier.verify

        def verify_rows(pools, tokens, page_table, seq_lens, lengths, active, params_list):
            logits = verify(pools, tokens, page_table, seq_lens, lengths, active, params_list)
            for slot, req in server.scheduler.running.items():
                for j in range(int(lengths[slot])):
                    rows[(req.rid, req.num_generated + j)] = logits[slot, j].float().clone()
            return logits

        server.verifier.verify = verify_rows
        return
    eng = server.engine
    dispatch, sample, current = eng.dispatch_decode, eng._sample, []

    def dispatch_decode(**kw):
        current[:] = [(slot, req.rid, server._disp[req.rid].generated)
                      for slot, req, _ in kw["payload"]]
        try:
            dispatch(**kw)
        finally:
            current.clear()

    def sample_rows(logits, dev):
        for slot, rid, i in current:
            rows[(rid, i)] = logits[slot].clone()
        return sample(logits, dev)

    eng.dispatch_decode, eng._sample = dispatch_decode, sample_rows


def greedy_accounting(spec_tokens: dict, plain_tokens: dict, spec_rows: dict,
                      plain_rows: dict):
    """spec_tokens, plain_tokens: {rid: generated tokens} of the two runs;
    the rows as :func:`record_rows` keeps them (the speculative run's are
    verify rows v, the plain run's decode rows d). Returns (noise, splits,
    unexplained):

    - noise: over the matched positions of every request (each token index
      before the request's first divergence), the largest change of the
      margin between the plain row's top two tokens a and b,
      |(v[a] - v[b]) - (d[a] - d[b])|;
    - splits: each request's first divergence as (rid, index, margin), the
      margin d[plain token] - d[speculative token] by which the plain run
      preferred its own token there;
    - unexplained: the splits whose margin exceeds the noise. A first token
      that differs comes from the prefill in both runs and is unexplained
      at margin inf."""
    noise, splits = 0.0, []
    for rid, want in plain_tokens.items():
        got = spec_tokens[rid]
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if first == 0:
            splits.append((rid, 0, float("inf")))
            continue
        for i in range(1, len(want) if first is None else first):
            d, v = plain_rows[(rid, i)].float(), spec_rows[(rid, i)].float()
            a, b = torch.topk(d, 2).indices
            noise = max(noise, float(((v[a] - v[b]) - (d[a] - d[b])).abs()))
        if first is not None:
            d = plain_rows[(rid, first)].float()
            splits.append((rid, first, float(d[want[first]] - d[got[first]])))
    return noise, splits, [sp for sp in splits if sp[2] > noise]


def run_gate(args, server, model, params, prompts, results, sampling, spec_rows, *,
             model_drafter):
    """The reference launcher's gate: greedy speculative tokens equal to a
    non-speculative run's, and an acceptance rate above 0 (for a model
    drafter under greedy, read from a temperature-1.0 pass). On the card
    under a policy other than fp32 the verify step and plain decode
    compute differently by design, so tokens that part pass only within
    :func:`greedy_accounting`. ``spec_rows`` holds the speculative run's
    rows (:func:`record_rows`). Raises SystemExit on failure."""
    failures = []
    s = server.stats
    if args.temperature <= 0:
        ref = Server(model, params, server.config, seed=args.seed, device=args.device)
        plain_rows = {}
        record_rows(ref, plain_rows)
        for p in prompts:
            ref.submit(p, max_new_tokens=args.max_new, sampling=sampling, priority=args.priority)
        want = {rid: r.out_tokens for rid, r in ref.run().items()}
        got = {rid: r.out_tokens for rid, r in results.items()}
        if got == want:
            print("spec gate: greedy parity with non-speculative decode confirmed")
        elif model.device.type == "cuda" and model.policy.name != "fp32":
            noise, splits, bad = greedy_accounting(got, want, spec_rows, plain_rows)
            print(f"spec gate: {len(want) - len(splits)} of {len(want)} requests give the "
                  f"non-speculative tokens; divergences (request, index, the plain run's "
                  f"margin for its token) {splits} against the largest verify/decode change "
                  f"of a top-2 margin before them, {noise:.4g}")
            if bad:
                failures.append(f"greedy divergences beyond the verify/decode difference: {bad}")
        else:
            failures.append("greedy speculative output diverges from the non-speculative run")
    acc = s.acceptance_rate
    if model_drafter and args.temperature <= 0:
        server.reset()
        for p in prompts:
            server.submit(p, max_new_tokens=args.max_new, sampling=SamplingParams(1.0, 0, 1.0))
        server.run()
        acc = server.stats.acceptance_rate
        print(f"spec gate: temperature-1.0 acceptance {acc:.0%} ({server.stats.spec_accepted}/"
              f"{server.stats.spec_drafted} drafts)")
    if acc <= 0.0:
        failures.append("speculative acceptance rate is 0")
    if failures:
        raise SystemExit("spec gate FAILED: " + "; ".join(failures))
    print("spec gate passed")
