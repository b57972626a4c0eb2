"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave + MoE 16e
top-2 every other layer (arXiv:2403.19887).

Family adaptation, as the reference's: Jamba uses Mamba-1 SSM blocks; the
hybrid substrate instantiates Mamba-2 SSD blocks with matched d_state and
width.  Attention layers are 1 in 8 (offset 4); MoE replaces the MLP on
every second layer.

long_500k runs: the decode state is dominated by the SSM layers (O(1)); only
9 of 72 layers hold 524k KV.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=24576, vocab_size=65536,
        num_experts=16, top_k=2, moe_d_ff=24576, moe_layer_period=2,
        attn_period=8, attn_layer_offset=4,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
        ssm_ngroups=1, conv_kernel=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512,
        num_experts=4, top_k=2, moe_d_ff=128, moe_layer_period=2,
        attn_period=8, attn_layer_offset=4,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=8,
        ssm_ngroups=1, conv_kernel=4, rope_theta=10000.0, dtype="float32",
    )
