"""zamba2-1.2b [hybrid] — 38 Mamba2 layers d2048 + SHARED attention block
(32H kv32, dff8192) applied every 6 SSM layers; ssm_state=64, v32000.
Runs long_500k (constant-memory SSM decode; the shared block keeps one KV
slot per application point).  [arXiv:2411.15242; hf]"""

from repro_torch.models.config import ModelConfig

from .shapes import LM_SHAPES


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv_width=4,
        shared_attn_period=6,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
        shapes=LM_SHAPES, skip_long_context=False,
    )
