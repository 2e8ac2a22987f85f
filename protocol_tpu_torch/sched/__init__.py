"""Scheduling layer of the port (``protocol_tpu/sched/``): the batch matcher."""
