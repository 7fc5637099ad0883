"""Serving: the batched engine and the continuous-batching scheduler."""

from repro_torch.sample import SamplingParams  # noqa: F401

from .engine import ServeEngine  # noqa: F401
from .scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    FinishReason,
    HostSwapStore,
    PageAllocator,
    PrefixIndex,
    Request,
    RequestRejected,
)
