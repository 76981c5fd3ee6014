"""The GEMM-Op's share of its roofline in the traced slice: the least time
of the GEMM work the slice's tokens needed (``perfbench/yardstick.py``,
from the configuration's shapes: every weight once a step, each decode
token's rows and each prompt token's rows, a MoE token's through its
routed experts and the router only, logits for the decode tokens and the
prompts' last tokens) over the device time of the GEMM-Op's kernels. The
work is counted the same whatever dispatch the program runs: a dense MoE
dispatch that multiplies every expert reads low here. The chunked
prefill's attention products, which also run on the GEMM-Op, are not
counted, so the share reads low by their part. Steps are the registry's
harvests between the slice's two synchronised ends. Layer: kernels,
GEMM-Op."""

from perfbench import yardstick as ys
from perfbench.program import GEMM_KERNELS

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    o, shape = run["observed"], run["shape"]
    sl = o["slice"]
    busy = run["trace"].time_s(GEMM_KERNELS)
    if busy <= 0:
        return None
    bound = (ys.gemm_bound_s(shape, steps=sl["decode_steps"], tokens=sl["decode_tokens"],
                             head_rows=sl["decode_tokens"])
             + ys.gemm_bound_s(shape, steps=sl["prefill_steps"], tokens=sl["prefill_tokens"],
                               head_rows=o["slice_first_tokens"]))
    return 100.0 * bound / busy
