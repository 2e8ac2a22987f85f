"""Session checkpoints (``protocol_tpu/faults/``, in part:
:mod:`.checkpoint`). The chaos plane (fault plans, injectors, the harness)
is ROADMAP queue A, M6."""
