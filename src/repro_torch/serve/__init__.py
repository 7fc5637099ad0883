"""Serving: the batched engine, the continuous-batching scheduler and
batched speculative decoding."""

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
from .speculative import speculative_decode  # noqa: F401
