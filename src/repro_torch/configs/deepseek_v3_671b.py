"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 experts
(arXiv:2412.19437).  First 3 layers dense (d_ff 18432); MoE layers use
2048-wide experts.  MTP head omitted (orthogonal to elasticity; DESIGN.md §6).

long_500k skipped: full attention.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
        d_ff=18432, vocab_size=129280,
        num_experts=256, top_k=8, num_shared_experts=1, moe_d_ff=2048,
        moe_layer_period=1, first_k_dense=3,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
        skip_shapes=(("long_500k", "full attention (MLA latent cache is "
                      "linear in memory but score compute stays quadratic)"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe",
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=8,
        d_ff=256, vocab_size=512,
        num_experts=8, top_k=2, num_shared_experts=1, moe_d_ff=64,
        moe_layer_period=1, first_k_dense=1,
        use_mla=True, q_lora_rank=64, kv_lora_rank=32,
        qk_rope_dim=16, qk_nope_dim=16, v_head_dim=16,
        rope_theta=10000.0, dtype="float32",
    )
