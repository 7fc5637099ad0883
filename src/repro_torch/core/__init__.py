"""SVE core primitives the port needs: VLA integer helpers, predicates, page
tables, and the device rule."""
