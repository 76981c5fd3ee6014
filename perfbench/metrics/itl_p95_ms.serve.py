"""95th percentile of the gaps between two consecutive tokens of one
request, both harvested in the window (the benchmark's stamps where
``Server.step`` returns each token). Layer: the engine core: the steps
that carry a (P, chunk) prefill set it."""
import numpy as np

MOVES = "out_tok_s"


def read(run: dict) -> float | None:
    s = run["observed"]["itl_s"]
    return 1e3 * float(np.percentile(s, 95)) if s else None
