"""moonshot-v1-16b-a3b [moe] — kimi/Moonlight: 48L d2048 16H (kv16) dff1408,
64 routed experts top-6 + 2 shared experts, first layer dense (11264).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""

from repro_torch.models.config import ModelConfig

from .shapes import LM_SHAPES


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        n_experts=64, top_k=6, capacity_factor=1.25,
        first_k_dense=1, d_ff_dense=11264, n_shared_experts=2,
        norm="rmsnorm", activation="swiglu", rope_theta=50000.0,
        shapes=LM_SHAPES, skip_long_context=True,
    )
