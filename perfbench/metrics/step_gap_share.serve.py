"""Share of the server loop's time over the window in which the card's
stream held no step: one less the registry's prefill and decode seconds
(each step's span on the stream, window deltas) over the wall time of the
window's ``Server.step`` calls. Small: the card's idle time lies inside the
steps, whose launches wait on the host; large: the loop between two
dispatches leaves the card idle. Layer: the server and its scheduler."""

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    w, steps = run["observed"]["window"], run["observed"]["step_s"]
    wall = sum(steps[False]) + sum(steps[True])
    if not wall or "prefill_s" not in w or "decode_s" not in w:
        return None
    return 100.0 * (1.0 - (w["prefill_s"] + w["decode_s"]) / wall)
