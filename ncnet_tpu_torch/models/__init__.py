"""Trunks, the NC stack and ImMatchNet (counterparts of ``ncnet_tpu/models``)."""
