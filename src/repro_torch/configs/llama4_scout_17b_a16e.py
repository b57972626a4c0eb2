"""llama4-scout-17b-a16e [moe] — 16 experts, top-1 routing + shared expert,
early fusion (hf:meta-llama/Llama-4-Scout-17B-16E).

long_500k skipped: full attention (iRoPE chunking not part of the assigned
config).  MoE on every layer; the expert dimension leads every expert
weight, so it shards over an expert-parallel group.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        num_experts=16, top_k=1, num_shared_experts=1, moe_d_ff=8192,
        moe_layer_period=1,
        skip_shapes=(("long_500k", "full attention; see DESIGN.md §4"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe",
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=2,
        d_ff=256, vocab_size=512,
        num_experts=4, top_k=1, num_shared_experts=1, moe_d_ff=256,
        moe_layer_period=1, rope_theta=10000.0, dtype="float32",
    )
