"""The scheduler backend's stateless gRPC surface
(``protocol_tpu/services/scheduler_grpc.py``, in part)."""
