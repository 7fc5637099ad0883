"""command-r-plus-104b [dense] — 64L d12288 96H (kv8) dff33792 v256000.
Cohere style: parallel attention+MLP block, layernorm, no bias, tied
embeddings.  [hf:CohereForAI/c4ai-command-r-v01; unverified]"""

from repro_torch.models.config import ModelConfig

from .shapes import LM_SHAPES


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=33792, vocab_size=256000, head_dim=128,
        norm="layernorm", activation="swiglu", parallel_block=True,
        tie_embeddings=True, rope_theta=75000000.0,
        shapes=LM_SHAPES, skip_long_context=True,
    )
