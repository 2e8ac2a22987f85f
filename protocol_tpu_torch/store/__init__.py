"""The orchestrator's node record (a copy of ``protocol_tpu/store/domains/node_store.py``)."""
