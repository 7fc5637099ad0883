"""seamless-m4t-large-v2 [audio] — enc-dec backbone, 24 encoder + 24 decoder
layers, d1024 16H (kv16) dff8192 v256206 (padded 256256).  The speech
frontend is a STUB: input_specs provides precomputed frame embeddings.
[arXiv:2308.11596; hf]"""

from repro_torch.models.config import ModelConfig

from .shapes import LM_SHAPES


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=48, n_enc_layers=24, n_dec_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=256206,
        norm="layernorm", activation="gelu", use_bias=True,
        rope_theta=10000.0,
        shapes=LM_SHAPES, skip_long_context=True,
    )
