"""Mean wall time of a server step that carries no prefill chunk (one
decode step dispatched, the step before it harvested) over the window,
timed on the host around ``Server.step``. Layer: the engine core."""

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    s = run["observed"]["step_s"][False]
    return 1e3 * sum(s) / len(s) if s else None
