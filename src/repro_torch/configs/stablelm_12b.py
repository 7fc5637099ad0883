"""stablelm-12b [dense] — 40L d5120 32H (kv8) dff13824 v100352.
No ``head_dim``: the head dim is 5120 / 32 = 160, and the 25% partial
rotary turns 40 of its dims.
[hf:stabilityai/stablelm-2-1_6b; hf]"""

from repro_torch.models.config import ModelConfig

from .shapes import LM_SHAPES


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=13824, vocab_size=100352,
        norm="layernorm", activation="swiglu",
        partial_rotary_factor=0.25, rope_theta=10000.0,
        shapes=LM_SHAPES, skip_long_context=True,
    )
