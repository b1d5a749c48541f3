"""The native graph builder (``bindings``), the port's copy of ``lgcnhs_tpu/native``."""
