"""Model configuration covering all assigned architecture families.

A copy of ``repro.models.config`` (the JAX package) with a ``torch_dtype``
property in place of ``jnp_dtype``.  One dataclass describes dense / MoE /
SSM / hybrid / enc-dec / VLM-backbone transformers; a config is compiled into
a sequence of *segments* (pattern of block types, repeated).  The port runs
the dense and ssm families so far; the other fields are kept so that configs
stay field-for-field equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Block type ids used in segment patterns.
ATTN = "attn"          # full self-attention block (GQA or MLA) + MLP (or MoE)
MAMBA = "mamba"        # Mamba2 SSD block
MOE = "moe"            # attention + MoE MLP
MAMBA_MOE = "mamba_moe"  # Mamba2 block + MoE MLP (jamba-style)
ATTN_MOE = "attn_moe"  # attention + MoE MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    activation: str = "silu"         # silu | relu2 | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    dtype: str = "bfloat16"
    dropout_rate: float = 0.0
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # expert hidden dim (0 -> d_ff)
    moe_layer_period: int = 1        # MoE every k-th layer (jamba: 2)
    first_k_dense: int = 0           # deepseek-v3: first 3 layers dense
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0               # >0 enables SSD blocks
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    conv_kernel: int = 4

    # --- hybrid (jamba) ---
    attn_period: int = 0             # one attn layer per `attn_period` layers
    attn_layer_offset: int = 0

    # --- enc-dec (whisper) ---
    is_encdec: bool = False
    encoder_layers: int = 0
    decoder_layers: int = 0
    max_source_positions: int = 1500  # whisper frame positions (stub frontend)

    # --- modality frontend stub (vlm/audio) ---
    frontend_embeds: int = 0         # number of precomputed prefix embeddings

    # --- lowering control ---
    scan_layers: bool = True         # False: unroll (exact cost analysis)

    # --- perf knobs (§Perf hillclimbing) ---
    attn_chunked: bool = False       # online-softmax chunked attention (flash
                                     # semantics in plain tensor code)
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    seq_shard_acts: bool = False     # shard activations' seq dim over `model`
                                     # between blocks (SP: RS+AG instead of AR)
    moe_row_dispatch: bool = False   # per-sample-row expert capacity: cumsum/
                                     # scatter stay local to the batch shard
                                     # (no global token ranking collective)
    mla_absorb: bool = False         # absorbed MLA decode: attention runs in
                                     # the latent space (w_kv_b folded into q
                                     # and o) — no per-token KV re-expansion
    mamba_split_proj: bool = False   # slice in_proj weights per component so
                                     # z/x/B/C/dt matmuls shard cleanly (the
                                     # packed-dim split boundaries misalign
                                     # with TP shards -> activation reshards)

    # --- assigned input shapes (overridable per arch) ---
    shapes: Tuple[Tuple[str, int, int], ...] = (
        ("train_4k", 4096, 256),
        ("prefill_32k", 32768, 32),
        ("decode_32k", 32768, 128),
        ("long_500k", 524288, 1),
    )
    # which shapes to skip and why (e.g. long_500k for pure full attention)
    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.moe_d_ff == 0 and self.num_experts:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # ---- derived ----
    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def block_pattern(self):
        """Return list of (pattern, repeats). pattern is a tuple of block ids."""
        L = self.num_layers
        if self.is_encdec:
            # handled by encdec model; pattern covers decoder blocks
            return [((ATTN,), self.decoder_layers or L)]
        if self.family == "ssm":
            return [((MAMBA,), L)]
        if self.family == "hybrid":
            p = self.attn_period
            pat = []
            for i in range(p):
                attn = (i == self.attn_layer_offset)
                moe = (i % self.moe_layer_period == 1) if self.num_experts else False
                if attn:
                    pat.append(ATTN_MOE if moe else ATTN)
                else:
                    pat.append(MAMBA_MOE if moe else MAMBA)
            assert L % p == 0
            return [(tuple(pat), L // p)]
        if self.num_experts:
            segs = []
            if self.first_k_dense:
                segs.append(((ATTN,), self.first_k_dense))
            rest = L - self.first_k_dense
            if self.moe_layer_period == 1:
                segs.append(((ATTN_MOE,), rest))
            else:
                p = self.moe_layer_period
                pat = tuple(ATTN_MOE if i % p == p - 1 else ATTN for i in range(p))
                assert rest % p == 0
                segs.append((pat, rest // p))
            return segs
        return [((ATTN,), L)]

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, V = self.d_model, self.vocab_size
        n = V * d  # embed
        if not self.tie_embeddings:
            n += V * d
        for pat, rep in self.block_pattern():
            for blk in pat:
                n += rep * self._block_params(blk)
        if self.is_encdec:
            n += self.encoder_layers * self._block_params(ATTN)
            # cross attention per decoder layer
            n += (self.decoder_layers or self.num_layers) * 4 * d * d
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: only top_k + shared experts)."""
        d, V = self.d_model, self.vocab_size
        n = V * d
        if not self.tie_embeddings:
            n += V * d
        for pat, rep in self.block_pattern():
            for blk in pat:
                n += rep * self._block_params(blk, active=True)
        if self.is_encdec:
            n += self.encoder_layers * self._block_params(ATTN, active=True)
            n += (self.decoder_layers or self.num_layers) * 4 * d * d
        return n

    def _block_params(self, blk: str, active: bool = False) -> int:
        d = self.d_model
        n = 0
        if blk in (ATTN, ATTN_MOE, MOE):
            if self.use_mla:
                qr = self.q_lora_rank or d
                qdim = self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                n += d * qr + qr * qdim if self.q_lora_rank else d * qdim
                n += d * (self.kv_lora_rank + self.qk_rope_dim)
                n += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                n += self.num_heads * self.v_head_dim * d
            else:
                hd = self.head_dim
                n += d * self.num_heads * hd          # q
                n += 2 * d * self.num_kv_heads * hd   # k, v
                n += self.num_heads * hd * d          # o
        if blk in (MAMBA, MAMBA_MOE):
            di, ds, ng = self.d_inner, self.ssm_state, self.ssm_ngroups
            n += d * (2 * di + 2 * ng * ds + self.ssm_heads)  # in_proj
            n += self.conv_kernel * (di + 2 * ng * ds)        # conv
            n += 3 * self.ssm_heads                            # A, D, dt_bias
            n += di * d                                        # out_proj
        # MLP / MoE
        mlp_mats = 2 if self.activation == "relu2" else 3
        if blk in (ATTN, MAMBA):
            n += mlp_mats * d * self.d_ff
        elif blk in (ATTN_MOE, MAMBA_MOE, MOE):
            e = (self.top_k + self.num_shared_experts) if active else (
                self.num_experts + self.num_shared_experts)
            n += e * mlp_mats * d * self.moe_d_ff
            n += d * self.num_experts  # router
        n += 2 * d  # norms
        return n
