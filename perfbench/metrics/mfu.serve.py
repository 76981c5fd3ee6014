"""The whole step's share of the card's fp8 peak in the traced slice: the
model FLOPs of every prompt and output token processed (two a weight a
token, a MoE token its routed experts only; the head for the tokens that
need logits; causal attention over each token's keys) over the slice's
length times 1979 TFLOP/s. Layer: the model."""

from perfbench import yardstick as ys

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    o, shape = run["observed"], run["shape"]
    sl = o["slice"]
    head = shape["d_model"] * shape["vocab_size"]
    body = ys.active_weights(shape) - head
    flops = (2.0 * body * (sl["prefill_tokens"] + sl["decode_tokens"])
             + 2.0 * head * (sl["decode_tokens"] + o["slice_first_tokens"])
             + ys.attention_flops(shape, o["slice_prompt_pairs"]
                                  + sum(p + 1 for p in o["slice_decode_lens"])))
    if flops <= 0:
        return None
    return 100.0 * flops / (run["trace"].window_s * ys.FP8_FLOP_S)
