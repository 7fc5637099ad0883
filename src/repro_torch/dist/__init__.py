"""repro_torch.dist — cluster-scale VLA on ``torch.distributed``: the
paper's vector-length-agnostic contract lifted from lanes to ranks.
Logical axis names resolve onto whatever process mesh is present
(``sharding``), horizontal reductions become deterministic cross-rank
collectives (``collectives``), and the serving state and weights are cut
to each rank's block (``serve``).
"""

from . import collectives, serve, sharding  # noqa: F401

__all__ = ["sharding", "collectives", "serve"]
