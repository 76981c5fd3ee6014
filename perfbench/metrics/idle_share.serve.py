"""Share of the traced slice in which no operation ran on the device (one
less the union of the device's operation intervals over the slice), from
a profile of the device's activity alone. Layer: the device."""

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    t = run["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
