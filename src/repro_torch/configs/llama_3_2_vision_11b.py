"""llama-3.2-vision-11b [vlm] — 40L d4096 32H (kv8) dff14336 v128256.
Cross-attn image layers every 5th (8 of 40, HF cross_attention_layers).
Vision frontend is a stub: input_specs provides patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from repro_torch.models.config import ModelConfig

from .shapes import LM_SHAPES


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256, head_dim=128,
        norm="rmsnorm", activation="swiglu", rope_theta=500000.0,
        cross_attn_group=5, n_cross_tokens=1024,
        shapes=LM_SHAPES, skip_long_context=True,
    )
