"""Per-lane predicated sampling: ``params`` (per-request spec and batched
lane state), ``processors`` (vocab keep-predicates and penalty rewrites),
``sampler`` (the ``sample`` entry point, bit-exact argmax under the greedy
predicate), ``prng`` (``jax.random``'s threefry in PyTorch), ``rejection``
(speculative decoding's distribution-preserving acceptance) and
``numpy_ref`` (the O(V) scalar oracle)."""

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
from .rejection import residual_dist, speculative_accept  # noqa: F401
from .sampler import (  # noqa: F401
    categorical_probs,
    greedy_tokens,
    gumbel_argmax,
    process_logits,
    sample,
)
