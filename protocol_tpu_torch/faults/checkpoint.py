"""Warm session checkpoints: one crash-safe journal a session
(``protocol_tpu/faults/checkpoint.py``).

Without them a servicer that restarts loses every session's arena, and
every client re-opens from a full snapshot at once. The checkpointer keeps
a journal a session, flushed on the tick cadence before the tick is
acknowledged, so a restarted servicer rehydrates each session warm and
``AssignDelta`` resumes at the journal's tick.

A journal is a trace file in the reference's format
(:mod:`protocol_tpu_torch.trace.format`: ``PTTRACE1`` frames), readable by
either package:

    META      JSON: the session's identity, solve parameters, tick cursor,
              retransmit CRC and the arena's cadence cursors (the
              reference's keys)
    SNAPSHOT  the session's current columns (padded, with the valid mask)
              as the wire's ``AssignRequestV2``
    ARENA     the carried solver state (``TorchSolveArena.export_state``,
              ``pack_arrays``): the candidate lists depend on the path the
              warm ticks took, so only with this frame does the restored
              chain continue bit for bit as the uninterrupted one would
    OUTCOME   the tick and the last plan acknowledged (what a retransmit
              replays)

Writes go to a temporary file and ``os.replace``; frames carry their CRC,
so a kill mid-flush leaves the previous journal or a torn temporary file
nobody reads. A journal that does not load (torn, foreign, a kernel or a
session kind the port does not serve) is skipped and counted: its client
re-opens down its ladder, as it would without journals.

Restore builds the arena on the servicer's device
(``make_solve_arena(..., device=)``); the arena's provenance tag
(``native_isa``, ``torch:<device type>``) decides whether its carry is
honoured. A journal the reference wrote, or one written on another device
type, restores as an honest cold re-ground, never as an error. The port
serves no stream sessions (ROADMAP queue A, M5) and never writes the stream
META; a journal that carries one loads as a batch session where the
reference's loader would (its carry fell back to cold), and is skipped and
counted where the reference would re-arm its stream engine.

Namespaces: journals live under ``<root>/<proc_id>/``, and a checkpointer
reads only its own, so processes share one root. :meth:`handoff` renames a
journal into another process's namespace (``os.replace``: it is in exactly
one namespace at every instant), and that process rehydrates it on its
next delta miss (:meth:`SessionCheckpointer.load_one`).

Fences: each namespace has a monotonic epoch (``FENCE.json``). The
checkpointer adopts the epoch it finds at start and re-reads the file
(one ``os.stat`` a check) on every flush: a higher epoch means this process
was ejected and its journals re-routed, so the flush refuses and the
servicer answers ``moved:`` instead of acknowledging. The stamp carries
the topology after the ejection, so the redirect names each session's new
home.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Optional

import numpy as np

from protocol_tpu_torch.trace import format as tfmt

log = logging.getLogger(__name__)

_META_KIND = "session-checkpoint"
_SUFFIX = ".ckpt"
FENCE_NAME = "FENCE.json"


def fence_path(root: str, proc_id: str) -> str:
    return os.path.join(root, str(proc_id), FENCE_NAME)


def read_fence(root: str, proc_id: str) -> dict:
    """The namespace's fence stamp, ``{"epoch": int, "topology": dict |
    None}``; epoch 0 where none was stamped (fencing is then inert)."""
    try:
        with open(fence_path(root, proc_id)) as fh:
            d = json.load(fh)
        return {"epoch": int(d.get("epoch", 0)), "topology": d.get("topology")}
    except (OSError, ValueError):
        return {"epoch": 0, "topology": None}


def stamp_fence(root: str, proc_id: str, epoch: Optional[int] = None,
                topology: Optional[dict] = None) -> int:
    """Write the namespace's fence stamp (temporary file + ``os.replace``).
    ``epoch=None`` takes the one after the stamp on disk: the file is the
    counter. Returns the epoch stamped."""
    if epoch is None:
        epoch = read_fence(root, proc_id)["epoch"] + 1
    path = fence_path(root, proc_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"epoch": int(epoch), "topology": topology}, fh)
    os.replace(tmp, path)
    return int(epoch)


def _fname(session_id: str) -> str:
    # session ids are tenant-chosen strings: a fixed-width hash names the
    # file, and the id itself rides in META
    return hashlib.sha1(session_id.encode()).hexdigest()[:24] + _SUFFIX


def journal_session_id(path: str) -> Optional[str]:
    """The session id in a journal's META frame (the first), or None for a
    torn or foreign file: what an orphaned journal is re-routed by."""
    try:
        for kind, payload in tfmt.read_frames(path):
            if kind == tfmt.KIND_META:
                meta = json.loads(payload)
                if meta.get("kind") == _META_KIND:
                    return meta.get("session_id")
                return None
            break
    except Exception:
        return None
    return None


class SessionCheckpointer:
    """Journal writer and loader over ``<root>/<proc_id>/``; restored
    arenas are built on ``device``."""

    def __init__(self, directory: str, every: int = 1, proc_id: str = "p0", device="cuda"):
        self.root = directory
        self.proc_id = str(proc_id)
        self.directory = os.path.join(directory, self.proc_id)
        self.every = max(1, int(every))
        self.device = device
        os.makedirs(self.directory, exist_ok=True)
        # the epoch stamped before this process started (0: inert); a
        # higher one on disk later means it was ejected
        self.fence_epoch = read_fence(self.root, self.proc_id)["epoch"]
        self._fence_file = fence_path(self.root, self.proc_id)
        self._fence_cache: tuple = (None, {"epoch": self.fence_epoch, "topology": None})
        self.flushes = 0
        self.flush_failures = 0
        self.handoffs = 0
        self.fence_refusals = 0
        self.journals_skipped = 0

    def path_for(self, session_id: str) -> str:
        return os.path.join(self.directory, _fname(session_id))

    def peer_path(self, session_id: str, proc_id: str) -> str:
        """Where ``session_id``'s journal lives in another process's
        namespace under the same root."""
        return os.path.join(self.root, str(proc_id), _fname(session_id))

    # ---------------- fencing ----------------

    def fence_state(self) -> dict:
        """The namespace's fence stamp on disk, cached on the file's
        (mtime, size): one ``os.stat`` a check."""
        try:
            st = os.stat(self._fence_file)
            sig: Optional[tuple] = (st.st_mtime_ns, st.st_size)
        except OSError:
            sig = None
        cached_sig, cached = self._fence_cache
        if sig != cached_sig:
            cached = read_fence(self.root, self.proc_id)
            self._fence_cache = (sig, cached)
        return cached

    def fence_superseded(self) -> bool:
        """True once an epoch above the adopted one was stamped here: this
        process was ejected, and may neither flush nor acknowledge."""
        return self.fence_state()["epoch"] > self.fence_epoch

    def due(self, tick: int) -> bool:
        """Is ``tick`` on the flush cadence? Tick 0 (the snapshot solve)
        always is: a crash before the first delta must restore too."""
        return tick == 0 or tick % self.every == 0

    # ---------------- write ----------------

    def flush_locked(self, session) -> bool:
        """Write the session's journal (the caller holds ``session.lock``).
        A failed flush warns and counts, never fails the RPC; a superseded
        fence refuses, counted apart."""
        if self.fence_superseded():
            self.fence_refusals += 1
            return False
        try:
            self._write_locked(session)
            self.flushes += 1
            return True
        except Exception:
            self.flush_failures += 1
            log.warning("session checkpoint flush failed for %s", session.session_id,
                        exc_info=True)
            return False

    def _write_locked(self, session) -> None:
        from protocol_tpu_torch.proto import scheduler_pb2 as pb
        from protocol_tpu_torch.proto import wire

        state = session.arena.export_state()
        meta = {
            "kind": _META_KIND,
            "session_id": session.session_id,
            "fingerprint": session.fingerprint,
            "kernel": session.kernel,
            "threads": int(session.threads),
            "top_k": int(session.top_k),
            "weights": [
                float(session.weights.price),
                float(session.weights.load),
                float(session.weights.proximity),
                float(session.weights.priority),
            ],
            "n_providers": int(session.n_providers),
            "n_tasks": int(session.n_tasks),
            "tick": int(session.tick),
            "last_delta_crc": int(session.last_delta_crc),
            "delta_rows_total": int(session.delta_rows_total),
        }
        if state is not None:
            meta["arena"] = {
                "warm_solves": state.pop("warm_solves"),
                "dual_age": state.pop("dual_age"),
                "weights_key": list(state.pop("weights_key")),
                "native_isa": state.pop("native_isa", "scalar"),
            }
        req = pb.AssignRequestV2(
            providers=wire.encode_providers_v2(tfmt._as_ns(session.p_cols)),
            requirements=wire.encode_requirements_v2(tfmt._as_ns(session.r_cols)),
            kernel=session.kernel,
            top_k=session.top_k,
        )
        final = self.path_for(session.session_id)
        tmp = final + ".tmp"
        writer = tfmt.TraceWriter(tmp, meta=meta)
        try:
            writer.write_snapshot(session.session_id, session.fingerprint, req)
            if state is not None:
                writer.write_arena(state)
            if session.last_p4t is not None:
                writer.write_outcome(int(session.tick), np.asarray(session.last_p4t, np.int32))
        finally:
            writer.close()
        os.replace(tmp, final)

    # ---------------- the migration's handoff ----------------

    def handoff(self, session_id: str, dst_proc_id: str) -> bool:
        """Move ``session_id``'s journal into ``dst_proc_id``'s namespace
        (``os.replace``: never in both). False when there is none to move
        (never flushed, or already handed off)."""
        src = self.path_for(session_id)
        dst = self.peer_path(session_id, dst_proc_id)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.replace(src, dst)
        except OSError:
            return False
        self.handoffs += 1
        return True

    # ---------------- read ----------------

    def load_all(self, limit: Optional[int] = None) -> list:
        """The loadable journals of this namespace as fresh sessions, sorted
        by session id. ``limit`` keeps the ``limit`` most recently flushed
        (restoring more than the servicer holds would evict the sessions
        just restored). An unloadable journal is skipped and counted."""
        try:
            names = sorted(n for n in os.listdir(self.directory) if n.endswith(_SUFFIX))
        except OSError:
            return []
        if limit is not None and len(names) > limit:
            def _mtime(name: str) -> float:
                try:
                    return os.path.getmtime(os.path.join(self.directory, name))
                except OSError:
                    return 0.0

            skipped = len(names) - limit
            names = sorted(sorted(names, key=_mtime)[-limit:])
            log.warning("checkpoint restore capped at %d sessions (%d older files skipped)",
                        limit, skipped)
        loaded = []
        for name in names:
            path = os.path.join(self.directory, name)
            try:
                loaded.append(self._load(path))
            except Exception:
                self.journals_skipped += 1
                log.warning("skipping unloadable session checkpoint %s", path, exc_info=True)
        loaded.sort(key=lambda s: s.session_id)
        return loaded

    def _load(self, path: str):
        from protocol_tpu_torch.fleet.fabric import estimate_arena_bytes
        from protocol_tpu_torch.ops.cost import CostWeights
        from protocol_tpu_torch.services.session_store import (
            SolveSession,
            make_solve_arena,
            parse_session_kernel,
        )

        meta: Optional[dict] = None
        snapshot = None
        arena_state: Optional[dict] = None
        outcome = None
        for kind, payload in tfmt.read_frames(path):
            if kind == -1:
                raise ValueError(f"{path}: torn checkpoint tail")
            if kind == tfmt.KIND_META:
                meta = json.loads(payload)
            elif kind == tfmt.KIND_SNAPSHOT:
                snapshot = tfmt._parse_snapshot(payload)
            elif kind == tfmt.KIND_ARENA:
                arena_state = tfmt.unpack_arrays(payload)
            elif kind == tfmt.KIND_OUTCOME:
                outcome = tfmt._parse_outcome(payload)
        if meta is None or meta.get("kind") != _META_KIND:
            raise ValueError(f"{path}: not a session checkpoint")
        if snapshot is None:
            raise ValueError(f"{path}: checkpoint has no snapshot frame")
        parsed = parse_session_kernel(meta["kernel"])
        if parsed is None:
            raise ValueError(
                f"{path}: checkpointed kernel {meta['kernel']!r} is not session-servable")
        engine, _ = parsed
        threads = int(meta["threads"])
        # the native engines raise KernelNotServed (M5): a counted skip
        arena = make_solve_arena(engine, k=int(meta["top_k"]), threads=threads,
                                 device=self.device)
        p_cols, r_cols = snapshot.p_cols, snapshot.r_cols
        if arena_state is not None:
            am = meta.get("arena") or {}
            arena_state["warm_solves"] = int(am.get("warm_solves", 0))
            arena_state["dual_age"] = int(am.get("dual_age", 0))
            arena_state["weights_key"] = tuple(am.get("weights_key") or meta["weights"])
            arena_state["native_isa"] = str(am.get("native_isa", "scalar"))
            arena.restore_state(tfmt._as_ns(p_cols), tfmt._as_ns(r_cols), arena_state)
        if meta.get("stream") and arena._p4t is not None:
            # the reference re-arms its stream engine over this warm carry;
            # the port serves no stream sessions
            raise ValueError(
                f"{path}: a stream session's journal (the stream engine is not served by "
                "the port; ROADMAP queue A, M5)")
        session = SolveSession(
            session_id=meta["session_id"],
            fingerprint=meta["fingerprint"],
            weights=CostWeights(*meta["weights"]),
            kernel=meta["kernel"],
            threads=threads,
            top_k=int(meta["top_k"]),
            p_cols=p_cols,
            r_cols=r_cols,
            n_providers=int(meta["n_providers"]),
            n_tasks=int(meta["n_tasks"]),
            arena=arena,
            tick=int(meta["tick"]),
            arena_bytes=estimate_arena_bytes(p_cols, r_cols, int(meta["top_k"])),
        )
        session.delta_rows_total = int(meta.get("delta_rows_total", 0))
        session.last_delta_crc = int(meta.get("last_delta_crc", 0))
        if outcome is not None:
            session.last_p4t = np.asarray(outcome.provider_for_task, np.int32)
        return session

    def load_one(self, session_id: str):
        """One session from this namespace (the lazy restore behind a delta
        miss after a handoff), or None: no journal here, an unloadable one
        (counted), or one handed off while it was being read."""
        path = self.path_for(session_id)
        if not os.path.exists(path):
            return None
        try:
            session = self._load(path)
        except Exception:
            self.journals_skipped += 1
            log.warning("skipping unloadable session checkpoint %s", path, exc_info=True)
            return None
        if session.session_id != session_id:
            # two session ids share a file-name prefix: never serve the other
            return None
        if not os.path.exists(path):
            # handed off mid-read: the target owns it now
            return None
        return session

    def drop(self, session_id: str) -> None:
        """Remove a session's journal (a client's drop, a TTL expiry)."""
        try:
            os.remove(self.path_for(session_id))
        except OSError:
            pass


def handoff_orphans(root: str, src_proc_id: str, route, topology: Optional[dict] = None,
                    stats: Optional[dict] = None) -> list:
    """Re-route a dead or ejected process's journals: each loadable journal
    under ``<root>/<src_proc_id>/`` moves to the namespace ``route(session
    id)`` names (None: it stays). The source's fence is superseded first
    (stamped with ``topology``), so a paused source that resumes refuses to
    flush or acknowledge. A journal whose META is torn is skipped and
    counted. Returns ``[(session_id, dst_proc_id), ...]``; ``stats`` gets
    ``journals_moved``, ``journals_skipped`` and ``fence_epoch``."""
    src_dir = os.path.join(root, str(src_proc_id))
    moved = []
    if stats is None:
        stats = {}
    stats.setdefault("journals_moved", 0)
    stats.setdefault("journals_skipped", 0)
    # the fence before the listing: a flush that beats the stamp is in the
    # listing, and one after it is refused by the fence
    stats["fence_epoch"] = stamp_fence(root, src_proc_id, topology=topology)
    try:
        names = sorted(n for n in os.listdir(src_dir) if n.endswith(_SUFFIX))
    except OSError:
        return moved
    for name in names:
        path = os.path.join(src_dir, name)
        sid = journal_session_id(path)
        if sid is None:
            stats["journals_skipped"] += 1
            log.warning("orphan journal %s has no readable META (torn mid-flush?): skipped",
                        path)
            continue
        dst_proc = route(sid)
        if dst_proc is None or str(dst_proc) == str(src_proc_id):
            continue
        dst_dir = os.path.join(root, str(dst_proc))
        os.makedirs(dst_dir, exist_ok=True)
        try:
            os.replace(path, os.path.join(dst_dir, name))
        except OSError:
            stats["journals_skipped"] += 1
            log.warning("orphan handoff failed for %s", path, exc_info=True)
            continue
        moved.append((sid, str(dst_proc)))
    stats["journals_moved"] = len(moved)
    return moved
