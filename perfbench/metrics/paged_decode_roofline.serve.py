"""The paged decode attention's share of its roofline in the traced
slice: the least time of the K/V pages the slice's decode tokens had to
read (each token's live pages at its position, every layer, with q, the
output and the page table; ``perfbench/yardstick.py``) over the device
time of the paged-decode kernel. Layer: kernels, paged decode."""

from perfbench import yardstick as ys
from perfbench.program import PAGED_DECODE_KERNELS

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    o, shape = run["observed"], run["shape"]
    busy = run["trace"].time_s(PAGED_DECODE_KERNELS)
    if busy <= 0 or not o["slice_decode_lens"]:
        return None
    cost = ys.paged_decode_cost(
        o["slice_decode_lens"], n_heads=shape["n_heads"], n_kv_heads=shape["n_kv_heads"],
        head_dim=shape["head_dim"], page_size=o["page_size"], kv_fmt=shape["kv_fmt"],
        q_fmt=shape["compute"], slots=o["slots"] * o["slice"]["decode_steps"],
        pages_per_slot=o["pages_per_slot"])
    return 100.0 * shape["n_layers"] * cost.bound_s / busy
