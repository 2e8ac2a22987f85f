"""Counterparts of ``protocol_tpu/trace``: the flight recorder's format
(``format.py``), the replayer (``replay.py``), the synthetic generators and
the trace factory (``synth.py``), and the CLI
(``python -m protocol_tpu_torch.trace {synth,record,replay,info}``). The
recorder's capture hooks are not ported yet (ROADMAP queue A, M6)."""
