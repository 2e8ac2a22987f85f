"""Candidate memo of the uncached candidate paths
(``protocol_tpu/sched/cand_cache.py:697 CandidateMemo``).

The reference's ``CandidateCache`` (the row-stable registry of the sparse
route above ``dense_cell_budget``) is not ported yet (ROADMAP.md queue A,
M1); the memo is, for the matcher's colocation phase.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch


class CandidateMemo:
    """Content-hash memo over bidirectional candidate generation: the
    generated [T, K_eff] structure is keyed on a hash of the ENCODED
    inputs plus every generation parameter, so a changed price, spec,
    priority or padding row changes the bytes and misses, and a
    byte-identical repeat hits. Hashing reads each column back from the
    device once (O(P + T) bytes) against generation's O(P x T) cells.

    A pure memo (LRU over :attr:`CAPACITY` keys): it cannot exploit
    partial overlap, only exact repeats."""

    CAPACITY = 4

    def __init__(self):
        self._slots: dict[tuple, tuple] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _fingerprint(enc) -> bytes:
        h = hashlib.sha1()
        for f in dataclasses.fields(enc):
            col = getattr(enc, f.name).detach().contiguous().cpu()
            h.update(str((f.name, tuple(col.shape), col.dtype)).encode())
            h.update(col.view(torch.uint8).numpy().tobytes())
        return h.digest()

    def get(self, ep, er, weights, *, k, tile, reverse_r, extra):
        """The memoised ``candidates_topk_bidir(ep, er, weights, ...)``."""
        from protocol_tpu_torch.ops.sparse import candidates_topk_bidir

        key = (
            self._fingerprint(ep), self._fingerprint(er),
            dataclasses.astuple(weights), k, tile, reverse_r, extra,
        )
        hit = self._slots.pop(key, None)
        if hit is not None:
            self.hits += 1
            self._slots[key] = hit  # re-insert: LRU order
            return hit
        self.misses += 1
        out = candidates_topk_bidir(
            ep, er, weights, k=k, tile=tile, reverse_r=reverse_r, extra=extra
        )
        self._slots[key] = out
        while len(self._slots) > self.CAPACITY:
            self._slots.pop(next(iter(self._slots)))
        return out
