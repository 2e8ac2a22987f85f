"""Host utilities copied from ``protocol_tpu/utils/``."""
