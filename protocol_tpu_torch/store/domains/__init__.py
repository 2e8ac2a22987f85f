"""Domain stores over the KV schema (``protocol_tpu/store/domains``, copied)."""
