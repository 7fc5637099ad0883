"""gemma3-27b [dense] — 62L d5376 32H (kv16) dff21504 v262144.
5:1 local:global attention (every 6th layer global), local window 1024,
qk-norm, geglu, sqrt(d) embedding scale.  [hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.models.config import ModelConfig

from .shapes import LM_SHAPES


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
        d_ff=21504, vocab_size=262144, head_dim=128,
        norm="rmsnorm", activation="geglu", qk_norm=True, embed_scale=True,
        local_window=1024, local_global_period=6, rope_theta=1000000.0,
        shapes=LM_SHAPES, skip_long_context=True,
    )
