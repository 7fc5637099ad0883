"""AdamW and its learning-rate schedule, mirroring ``repro.optim``."""

from .adamw import adamw_init, adamw_update, clip_by_global_norm  # noqa: F401
from .schedule import cosine_warmup  # noqa: F401
