"""Mean span of a decode step on the card's stream over the window: the
registry's decode seconds over its decode steps (window deltas), each step
charged from a timing event recorded before its first operation to the
event recorded after its last. Layer: the engine core."""

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    w = run["observed"]["window"]
    return 1e3 * w["decode_s"] / w["decode_steps"] if w.get("decode_steps") else None
