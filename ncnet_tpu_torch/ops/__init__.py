"""Tensor ops of the port (counterparts of ``ncnet_tpu/ops``)."""
