"""Mean span of a prefill step on the card's stream over the window: the
registry's prefill seconds over the prefill steps harvested (window
deltas). The engine charges each step from a timing event recorded before
its first operation to the event recorded after its last, so a step holds
the time the stream waited for the host to enqueue it, and none of the
step ahead of it. Layer: the engine core."""

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    w = run["observed"]["window"]
    return 1e3 * w["prefill_s"] / w["prefill_steps"] if w.get("prefill_steps") else None
