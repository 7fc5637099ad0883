"""stablelm-3b [dense] — 32L d2560 32H (kv32) dff6912 v50304.
StableLM-2 family: layernorm, partial rotary 25%.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""

from repro_torch.models.config import ModelConfig

from .shapes import LM_SHAPES


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab_size=50304,
        norm="layernorm", activation="swiglu",
        partial_rotary_factor=0.25, rope_theta=10000.0,
        shapes=LM_SHAPES, skip_long_context=True,
    )
