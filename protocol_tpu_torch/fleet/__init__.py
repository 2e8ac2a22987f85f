"""The fleet layer (``protocol_tpu/fleet/``, in part): admission control
(:mod:`.admission`) and the sharded session fabric with its byte budget and
the fleet's knobs (:mod:`.fabric`). The load generator is ROADMAP queue A,
M4c."""
