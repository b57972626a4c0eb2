"""deepseek-67b [dense] — llama-architecture (arXiv:2401.02954).
long_500k skipped: full attention."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b", family="dense",
        num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=22016, vocab_size=102400,
        rope_theta=10000.0,
        skip_shapes=(("long_500k", "full attention; see DESIGN.md §4"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b-smoke", family="dense",
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=2,
        d_ff=256, vocab_size=512, rope_theta=10000.0, dtype="float32",
    )
