"""Mean wall time of a server step that carries a (P, chunk) prefill step
beside its decode step, over the window, timed on the host around
``Server.step``. (The registry's prefill seconds cannot give it: with a
step in flight, the engine charges a prefill's time to the decode step
harvested before it.) Layer: the engine core."""

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    s = run["observed"]["step_s"][True]
    return 1e3 * sum(s) / len(s) if s else None
