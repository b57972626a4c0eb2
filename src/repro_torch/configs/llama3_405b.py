"""llama3-405b [dense] — GQA, 128k vocab (arXiv:2407.21783).
long_500k skipped: full attention."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
        d_ff=53248, vocab_size=128256,
        rope_theta=500000.0,
        skip_shapes=(("long_500k", "full attention; see DESIGN.md §4"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke", family="dense",
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=2,
        d_ff=256, vocab_size=512, rope_theta=10000.0, dtype="float32",
    )
