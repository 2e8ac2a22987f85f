"""Host-side models the matcher reads (copies of ``protocol_tpu/models/``)."""
