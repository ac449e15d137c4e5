"""Host-side data preparation (counterparts of ``ncnet_tpu/data``)."""
