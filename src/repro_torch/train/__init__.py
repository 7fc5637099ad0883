"""Training: the loss and the fused train step, mirroring ``repro.train``."""

from .loss import cross_entropy_loss  # noqa: F401
from .step import (init_state, make_grads, make_serve_fns,  # noqa: F401
                   make_train_step)
