"""Per-lane predicated sampling: ``params`` (per-request spec and batched
lane state), ``processors`` (vocab keep-predicates and penalty rewrites),
``sampler`` (the ``sample`` entry point, bit-exact argmax under the greedy
predicate), ``prng`` (``jax.random``'s threefry in PyTorch) and
``numpy_ref`` (the O(V) scalar oracle).  ``rejection.py`` comes with
speculative decoding."""

from .params import (  # noqa: F401
    GREEDY,
    SamplingParams,
    gather_lanes,
    greedy_state,
    is_all_greedy,
    lane_state,
    slot_update,
    split_keys,
)
from .sampler import (  # noqa: F401
    categorical_probs,
    greedy_tokens,
    gumbel_argmax,
    process_logits,
    sample,
)
