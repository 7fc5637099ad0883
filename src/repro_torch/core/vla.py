"""Vector-length agnosticism (SVE C1): loop trip counts and padding against a
symbolic width.  The port keeps only the integer helpers; Hopper tile widths
are chosen inside each kernel, so the TPU lane/VMEM constants have no
counterpart here."""

from __future__ import annotations


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def pad_to_vl(n: int, vl: int) -> int:
    return round_up(n, vl)
