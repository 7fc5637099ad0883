"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout module for module and imports
neither ``jax`` nor ``repro``.  Public functions keep the JAX package's
tensor layouts: weights ``(in, out)`` used as ``x @ w``, caches
``(L, B, Hkv, S, D)``, page pools ``(L, P, Hkv, ps, D)`` and page tables
``(B, n_pages)`` int32.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
