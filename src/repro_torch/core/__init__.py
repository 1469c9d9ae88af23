"""TAQA (two-stage online AQP, §3) and BSAP (block-sampling statistics with
a priori guarantees, §4): the host-side f64 statistics, copied from the
reference, and the two-stage driver over the port's engine."""
