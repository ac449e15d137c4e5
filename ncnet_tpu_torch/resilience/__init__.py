"""Durable writes of the port's artifacts (``ncnet_tpu/resilience``,
its ``durable`` module)."""
