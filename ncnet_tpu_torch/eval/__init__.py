"""Evaluation of the port (``ncnet_tpu/eval/``): PF-Pascal and synthetic
PCK, and the InLoc match dump."""
