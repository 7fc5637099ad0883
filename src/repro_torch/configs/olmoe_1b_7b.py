"""olmoe-1b-7b [moe] — 16L d2048 16H (kv16) dff1024 v50304, 64 experts top-8.
[arXiv:2409.02060; hf]"""

from repro_torch.models.config import ModelConfig

from .shapes import LM_SHAPES


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        n_experts=64, top_k=8, capacity_factor=1.25,
        norm="rmsnorm", activation="swiglu", qk_norm=True,
        rope_theta=10000.0,
        shapes=LM_SHAPES, skip_long_context=True,
    )
