"""The benchmark's configuration at sizes a CPU test run can hold: the
cell's own file with the widths, depth and vocabulary cut, and a mix of
the cell's kind with short prompts."""
import json
from pathlib import Path

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def phi(d: int = 64, vocab: int = 256, layers: int = 2) -> dict:
    c = json.loads((CONFIGS / "phi3.5-moe-42b-a6.6b.json").read_text())
    c.update(num_hidden_layers=layers, hidden_size=d, num_attention_heads=max(4, d // 32),
             num_key_value_heads=max(2, d // 64), intermediate_size=3 * d // 2,
             vocab_size=vocab, num_local_experts=4, num_experts_per_tok=2)
    return c


SERVE_MIX = {"kind": "serve_closed", "clients": 4, "prompt_tokens": {"mean": 20, "sd": 8},
             "output_tokens": {"mean": 10, "sd": 4}, "block": 8, "prefill_chunk": 16,
             "async_depth": 1}
