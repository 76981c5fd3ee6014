"""A whole run of the serve cell's driver at a size the CPU holds, the
check against the plain reference included: sound, it comes out correct;
with the timed path broken underneath, as each fault the cell can have
breaks it (``perfbench/faults.py``), it comes out not correct. (The look
for a card is the entry point's, which these runs skip.) Each run is held
to the cell's own limits, but for the least count of tokens checked:
outputs at this size are short."""
import time

import pytest

from perfbench import faults, manifest
from perfbench.kinds import serve_closed
from perfbench.run import passed
from perfbench.tests import sizes

SERVE_CELL = "phi3.5-moe.serve-16clients"


def _serve() -> dict:
    return serve_closed.run(sizes.phi(d=256, vocab=2048), sizes.SERVE_MIX, 2**31 + 17, 3.0,
                            trace=False, device="cpu",
                            limits=manifest.limits(SERVE_CELL) | {"tokens_checked": 10},
                            t_start=time.perf_counter())


def test_sound_serve_run_is_correct():
    res = _serve()
    assert passed(res["checks"]), res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_broken_serve_run_is_not_correct(fault):
    with faults.planted(fault):
        checks = _serve()["checks"]
    assert checks["tokens_checked"]["value"] >= 10
    gap = checks["worst_request_gap_sd"]
    assert gap["value"] > gap["limit"], checks


def test_planting_restores_the_program():
    from repro_torch.models.transformer import Transformer

    real = Transformer.decode_cb
    with faults.planted("one_slot"):
        assert Transformer.decode_cb is not real
    assert Transformer.decode_cb is real
