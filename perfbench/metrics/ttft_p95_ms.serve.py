"""95th percentile of submit -> first token harvested, over the requests
whose first token came in the window (the benchmark's stamps where
``Server.step`` returns each token). Layer: the server and its scheduler.
The closed loop keeps every slot full, so this tail is read at the
server's capacity and swings with the prefill steps' host time."""
import numpy as np

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    s = run["observed"]["ttft_s"]
    return 1e3 * float(np.percentile(s, 95)) if s else None
