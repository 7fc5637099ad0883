"""mamba2-130m [ssm] — 24L d768, attention-free SSD, ssm_state=128, v50280
(padded to 50304 for lane/TP divisibility — logits masked).  Runs long_500k.
[arXiv:2405.21060; unverified]"""

from repro_torch.models.config import ModelConfig

from .shapes import LM_SHAPES


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=50280, tie_embeddings=True,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv_width=4,
        norm="rmsnorm",
        shapes=LM_SHAPES, skip_long_context=False,
    )
