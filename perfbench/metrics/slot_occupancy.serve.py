"""Share of the decode lanes offered over the window that produced a
token (the registry's decode tokens over its slot steps, window deltas:
``ServerStats.utilization``). Layer: the server and its scheduler."""

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    w = run["observed"]["window"]
    return 100.0 * w["decode_tokens"] / w["slot_steps"] if w["slot_steps"] else None
