"""SVE core primitives, as in ``repro.core``: VLA integer helpers
(``vla``), predicates (``predicate``), partitions and lane permutation
(``partition``), first-faulting loads (``ffr``), ordered reductions
(``reductions``), page tables (``paging``), and the device rule
(``device``)."""
