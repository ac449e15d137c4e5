"""Wrappers of the hand-written Hopper kernels (sources in ``../csrc``)."""
