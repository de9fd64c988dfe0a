"""Tiny cells for the CPU tests: the benchmark's configurations cut to
widths a test run holds, computed in float32 so that the program and
the reference agree to rounding."""
import copy
import os

from bench import harness

ROOT = harness.ROOT


def config(name: str, dtype: str = "float32") -> dict:
    c = harness.load_json(os.path.join(ROOT, "bench", "configs",
                                       name + ".json"))
    c.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=128,
             vocab_size=256)
    c["run"] = dict(c["run"], pad_to=8, loss_chunk=32, attn_chunk=16,
                    dtype=dtype)
    return c


def pieces(cell: str, config_name: str = "qwen2-0.5b", batch: int = 2,
           seq: int = 64) -> dict:
    man = harness.manifest()
    p = harness.resolve(man, harness.find_cell(man, cell))
    p = copy.deepcopy(p)
    p["config"] = config(config_name)
    p["traffic"] = dict(p["traffic"], batch=batch, seq=seq)
    return p
