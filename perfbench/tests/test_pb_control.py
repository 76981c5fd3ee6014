"""The serve cell's control comes out not correct: the plain reference put
in the program's place one precision below the stated one (int4 operands
and KV for the stated E4M3), held to the cell's own limit, at a size a CPU
test run holds. (``perfbench/controls.py`` reads the same, and the E5M2
control, on the card at the cell's own size; ``PERF.md`` keeps those
readings.)"""
import time

import torch

from perfbench import manifest
from perfbench.controls import CONTROLS
from perfbench.kinds import serve_closed as sc
from perfbench.reference import decoder as ref
from perfbench.tests import sizes


def test_serve_control_is_not_correct():
    cfg = sizes.phi(d=256, vocab=2048)
    limit = manifest.limits("phi3.5-moe.serve-16clients")["worst_request_gap_sd"]
    _, served = sc.serve(cfg, sizes.SERVE_MIX, 2**31 + 23, 3.0, trace=False, device="cpu",
                         t_start=time.perf_counter())
    seqs, starts, tokens = sc.picked(served, 2**31 + 23)
    stated = sc.reference_logits(cfg, served["params"], seqs, starts, sc.reference_precision(cfg),
                                 "e4m3", "cpu")
    program = sc.gap_summary(sc.gap_sd(stated, [torch.tensor(t) for t in tokens]))
    prec = CONTROLS["int4"]
    control = sc.reference_logits(cfg, served["params"], seqs, starts, ref.Precision(**prec),
                                  prec["operand"], "cpu")
    lower = sc.gap_summary(sc.gap_sd(stated, [c.argmax(-1) for c in control]))
    assert program["worst_request"] < limit < lower["worst_request"], (program, lower)
