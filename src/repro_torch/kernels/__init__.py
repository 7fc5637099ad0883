"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each wrapper counts its launches in Python (``wrapper.launches``, and for the
flash kernels and the SSD scan ``wrapper.body_launches`` per body).  A CUDA
graph runs its kernels without calling the wrappers, so the engine takes the
counts of a graph's body at capture (``read_counts`` before and after) and
adds them once per replay (``add_counts``).
"""


def counted_wrappers() -> tuple:
    """Every wrapper that counts its launches."""
    from .daxpy import kernel as DK
    from .fadda import kernel as FK
    from .flash_attention import kernel as K
    from .moe_dispatch import kernel as MK
    from .ssd_scan import kernel as SK
    return (K.flash_dense_cuda, K.flash_paged_cuda, K.flash_paged_quant_cuda,
            K.flash_bwd_cuda, SK.ssd_scan_cuda, MK.moe_positions_cuda,
            FK.fadda_rows_cuda, DK.daxpy_cuda)


def read_counts() -> dict:
    """wrapper -> (launches, {body: launches}) as they stand."""
    return {fn: (fn.launches, dict(getattr(fn, "body_launches", {})))
            for fn in counted_wrappers()}


def set_counts(counts: dict) -> None:
    """Put back counts that ``read_counts`` returned."""
    for fn, (n, bodies) in counts.items():
        fn.launches = n
        if hasattr(fn, "body_launches"):
            fn.body_launches = dict(bodies)


def counts_since(before: dict) -> dict:
    """The launches made since ``before`` (a ``read_counts``)."""
    out = {}
    for fn, (n, bodies) in read_counts().items():
        n0, b0 = before[fn]
        out[fn] = (n - n0, {b: c - b0.get(b, 0) for b, c in bodies.items()})
    return out


def add_counts(delta: dict) -> None:
    """Add ``delta`` (a ``counts_since``) to every wrapper's counts."""
    for fn, (n, bodies) in delta.items():
        fn.launches += n
        for b, c in bodies.items():
            fn.body_launches[b] += c
