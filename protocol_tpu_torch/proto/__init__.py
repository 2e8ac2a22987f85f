"""The scheduler seam's wire messages (``scheduler_pb2``) and the v2
tensor-frame codecs (``wire``)."""
