"""Batched serving of the dense match path (counterpart of ``ncnet_tpu/serve``)."""
