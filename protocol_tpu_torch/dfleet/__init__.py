"""The distributed fleet's endpoint ring (``protocol_tpu/dfleet/``, in
part: :mod:`.topology`). The fleet manager, its failure detector and the
discovery endpoint are ROADMAP queue A, M4c."""
