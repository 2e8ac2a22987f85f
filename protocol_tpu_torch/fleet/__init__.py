"""The fleet layer's admission control (``protocol_tpu/fleet/``, in part)."""
