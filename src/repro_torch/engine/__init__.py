"""The columnar block-table engine: plans, expressions, sampling decisions,
the physical layer over the hand-written kernels, and the executor."""
