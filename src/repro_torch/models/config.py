"""Unified model configuration covering all assigned architecture families.

The port's own copy of ``repro.models.config`` (field for field, so config
files read the same in both packages); ``repro_torch`` imports nothing of
``repro``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"            # dense | moe | ssm | hybrid | encdec

    # trunk dims
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None   # default: d_model // n_heads

    # norms / misc
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    use_bias: bool = False
    activation: str = "swiglu"       # swiglu | geglu | gelu
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scale
    parallel_block: bool = False     # cohere-style parallel attn+mlp residual
    qk_norm: bool = False
    logit_softcap: Optional[float] = None

    # rope
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0

    # attention pattern
    local_window: Optional[int] = None   # sliding-window size for local layers
    local_global_period: Optional[int] = None  # gemma3: every Nth layer global
    cross_attn_group: Optional[int] = None     # vlm: group size; last-1 slot is cross
    n_cross_tokens: int = 1024                 # stub frontend token count

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0
    n_shared_experts: int = 0
    d_ff_dense: Optional[int] = None     # d_ff of dense-replace layers
    moe_groups: int = 1                  # GShard token groups (= data shards)

    # ssm (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    shared_attn_period: int = 6          # zamba2: shared block every N ssm layers

    # encdec
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # execution
    param_dtype: str = "float32"     # master weights
    compute_dtype: str = "bfloat16"  # activations / matmul inputs at scale
    attn_impl: str = "xla"           # xla (introspectable) | kernel (pallas)
    ssd_impl: str = "xla"
    remat: str = "none"              # none | full | dots
    act_shard: str = "none"          # none | tp | tp_sp (Megatron constraints)
    scan_layers_decode: bool = True  # False: unroll decode layers so XLA can
                                     # alias per-layer KV buffers (no scan-ys
                                     # double buffer — see EXPERIMENTS §Perf)
    vocab_pad_multiple: int = 128    # pad embedding tables (TPU lanes x TP)

    # assigned input shapes (seq_len, global_batch, kind) for the dry-run
    shapes: Tuple[Tuple[str, int, int, str], ...] = ()
    # families for which long_500k is skipped (full attention) — see DESIGN.md
    skip_long_context: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        qo = self.n_heads * hd
        kvd = self.n_kv_heads * hd
        attn = d * qo + 2 * d * kvd + qo * d
        mlp_mult = 3 if self.activation in ("swiglu", "geglu") else 2
        mlp = mlp_mult * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)

        if self.family == "dense":
            n = self.n_layers * (attn + mlp + 2 * d) + emb
            if self.cross_attn_group:
                n_cross = self.n_layers // self.cross_attn_group
                n += n_cross * (attn + mlp + 2 * d)
            return n
        if self.family == "moe":
            moe_mlp = mlp_mult * d * f * self.n_experts + d * self.n_experts
            shared = mlp_mult * d * f * self.n_shared_experts
            dense_layers = self.first_k_dense
            fd = self.d_ff_dense or f
            n = (self.n_layers - dense_layers) * (attn + moe_mlp + shared + 2 * d)
            n += dense_layers * (attn + mlp_mult * d * fd + 2 * d)
            return n + emb
        if self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            blk = (d * (2 * di + 2 * ns + self.n_ssm_heads)   # in_proj
                   + (di + 2 * ns) * self.ssm_conv_width       # conv
                   + di * d + 3 * self.n_ssm_heads + d)        # out_proj, A/D/dt_b, norm
            return self.n_layers * blk + emb
        if self.family == "hybrid":
            di, ns = self.d_inner, self.ssm_state
            blk = (d * (2 * di + 2 * ns + self.n_ssm_heads)
                   + (di + 2 * ns) * self.ssm_conv_width + di * d
                   + 3 * self.n_ssm_heads + d)
            shared_blk = attn + mlp + 2 * d
            return self.n_layers * blk + shared_blk + emb
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp + 2 * d)
            dec = self.n_dec_layers * (2 * attn + mlp + 3 * d)
            return enc + dec + emb
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp_mult = 3 if self.activation in ("swiglu", "geglu") else 2
        total = self.param_count()
        all_experts = (self.n_layers - self.first_k_dense) * mlp_mult * d * f * self.n_experts
        active = (self.n_layers - self.first_k_dense) * mlp_mult * d * f * self.top_k
        return total - all_experts + active
