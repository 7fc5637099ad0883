"""MoE dispatch: the rank kernel for Hopper, plain PyTorch versions, and the
dispatch-table builder."""

from .ops import build_dispatch, moe_positions  # noqa: F401
