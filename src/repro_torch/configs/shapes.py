"""The assigned LM input-shape set (seq_len, global_batch, kind) per cell."""

LM_SHAPES = (
    ("train_4k", 4096, 256, "train"),
    ("prefill_32k", 32768, 32, "prefill"),
    ("decode_32k", 32768, 128, "decode"),
    ("long_500k", 524288, 1, "long"),
)
