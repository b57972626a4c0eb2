"""mamba2-2.7b [ssm] — SSD state-space duality (arXiv:2405.21060),
hf:state-spaces/mamba2-2.7b.

Attention-free: decode state is O(1) in sequence length, so all four shapes
run, including long_500k.  The cluster always builds an untied ``head``
(``models/registry.py:init_head``) whatever ``tie_embeddings`` says, as the
reference's cluster mode does.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
        ssm_ngroups=1, conv_kernel=4,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm",
        num_layers=4, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=8,
        ssm_ngroups=1, conv_kernel=4, tie_embeddings=True, dtype="float32",
    )
