"""codeqwen1.5-7b [dense] — qwen1.5 architecture, MHA (kv = heads)
(hf:Qwen/CodeQwen1.5-7B).  long_500k skipped: full attention.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=13440, vocab_size=92416,
        rope_theta=1000000.0,
        skip_shapes=(("long_500k", "full attention; see DESIGN.md §4"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen-smoke", family="dense",
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=8,
        d_ff=256, vocab_size=512, rope_theta=10000.0, dtype="float32",
    )
