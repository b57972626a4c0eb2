"""nemotron-4-15b [dense] — GQA + squared-ReLU ungated MLP, 256k vocab
(arXiv:2402.16819).  long_500k skipped: full attention."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=24576, vocab_size=256000,
        activation="relu2", rope_theta=10000.0,
        skip_shapes=(("long_500k", "full attention; see DESIGN.md §4"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense",
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=2,
        d_ff=256, vocab_size=512, activation="relu2",
        rope_theta=10000.0, dtype="float32",
    )
