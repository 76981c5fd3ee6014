"""End-to-end LM training (the port of ``examples/train_lm.py``).

Trains the xlstm-125m architecture by default for a few hundred steps on
the synthetic pipeline; any registered arch is selectable. It wraps the
port's training launcher (``repro_torch.launch.train``), as the reference
wraps its own, and takes the launcher's flags (``--device cpu``,
``--smoke``, ``--layers``, ``--ckpt-dir DIR --ckpt-every N`` ...).

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 --seq 128 --batch 8
  PYTHONPATH=src python -m repro_torch.examples.train_lm --arch gemma2-2b --smoke --steps 50

Checkpoints are written only where ``--ckpt-dir`` says (the reference
writes to a fixed temporary directory).
"""
from __future__ import annotations

import sys

from repro_torch.launch import train


def main(argv=None) -> dict:
    args = list(sys.argv[1:] if argv is None else argv)
    joined = " ".join(args)
    if "--arch" not in joined:
        args = ["--arch", "xlstm-125m"] + args
    for flag, value in (("--steps", "300"), ("--seq", "128"), ("--batch", "8")):
        if flag not in joined:
            args += [flag, value]
    return train.main(args)


if __name__ == "__main__":
    main()
