"""In-process KV store with Redis semantics and an append-only journal
(``protocol_tpu/store/kv.py``, copied; its lock is a plain
``threading.RLock``).

A thread-safe dict engine with the Redis subset the control plane uses:

  strings   get / set (NX, EX) / mget / incr / delete / exists / expire
  hashes    hset / hget / hgetall / hdel / hincrby
  sets      sadd / srem / smembers / sismember / scard
  zsets     zadd / zscore / zrem / zrangebyscore / zremrangebyscore / zcard
  lists     rpush / lpush / lrange / lrem / llen
  pipeline  atomic multi-op batch under one lock

Lazy TTL expiry against a clock (``time_fn``: tests pass their own).
Keys and values are strings; callers do their own JSON.

Durability (``persist_path``): every mutation is appended to a JSON-lines
journal (line-buffered, so a killed process loses at most the line in
flight) and replayed at construction; the journal is compacted to a
minimal op sequence at load and past ``compact_threshold`` entries. TTLs
are journaled as absolute wall-clock deadlines, so a persistent store
defaults to ``time.time``. The journal's format is the reference's: a
journal written by either package loads in the other.
"""

from __future__ import annotations

import fnmatch
import functools
import json
import os
import threading
import time
from typing import Callable, Iterable, Optional


def _journaled(fn):
    """Decorator for mutating methods: append (method, args) to the journal
    after the outermost successful call. Nested journaled calls (e.g.
    ``hdel`` -> ``delete``) are not journaled — replaying the outer op
    reproduces them."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if self._journal is None:
            return fn(self, *args, **kwargs)
        with self._lock:
            self._jdepth += 1
            try:
                out = fn(self, *args, **kwargs)
            finally:
                self._jdepth -= 1
            # no-op writes are NOT journaled: a failed SET NX / EXPIRE on a
            # missing key mutated nothing, and replaying it (especially an
            # expired SET-with-TTL, which replay resolves by deleting the
            # key) would corrupt state that the original call never touched
            if self._jdepth == 0 and not (name in ("set", "expire") and not out):
                self._journal_append(name, args, kwargs)
            return out

    return wrapper


class KVStore:
    def __init__(
        self,
        time_fn: Optional[Callable[[], float]] = None,
        persist_path: Optional[str] = None,
        compact_threshold: int = 100_000,
    ):
        self._lock = threading.RLock()
        self._data: dict[str, object] = {}
        self._expiry: dict[str, float] = {}
        # persistence needs wall-clock TTLs; in-memory stays monotonic
        self._time = time_fn or (time.time if persist_path else time.monotonic)
        self._journal = None
        self._jdepth = 0
        self._journal_ops = 0
        self._compact_threshold = compact_threshold
        self._persist_path = persist_path
        if persist_path is not None:
            os.makedirs(os.path.dirname(persist_path) or ".", exist_ok=True)
            if os.path.exists(persist_path):
                self._replay(persist_path)
            self._compact()  # also (re)opens the journal for appending

    # ------------- persistence -------------

    def _journal_append(self, method: str, args: tuple, kwargs: dict) -> None:
        entry: dict = {"m": method, "a": list(args)}
        kw = dict(kwargs)
        # TTLs become absolute wall deadlines (restart-stable)
        if method == "set" and kw.get("ex") is not None:
            kw["abs_ex"] = self._time() + kw.pop("ex")
        if method == "expire":
            # expire(key, seconds) — seconds may be positional
            seconds = kw.pop("seconds", None)
            if seconds is None and len(entry["a"]) == 2:
                seconds = entry["a"].pop(1)
            entry["abs"] = self._time() + float(seconds)
        if kw:
            entry["kw"] = kw
        self._journal.write(json.dumps(entry) + "\n")
        self._journal_ops += 1
        if self._journal_ops >= self._compact_threshold:
            self._compact()

    def _replay(self, path: str) -> None:
        # self._journal is None here, so the @_journaled wrappers pass
        # straight through without re-journaling
        now = self._time()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn final line from a crash
                method = entry.get("m")
                args = entry.get("a", [])
                kw = dict(entry.get("kw", {}))
                if method == "expire":
                    remaining = entry.get("abs", now) - now
                    if remaining <= 0:
                        self._data.pop(args[0], None)
                        self._expiry.pop(args[0], None)
                    else:
                        self.expire(args[0], remaining)
                    continue
                abs_ex = kw.pop("abs_ex", None)
                fn = getattr(self, method, None)
                if fn is None:
                    continue
                if abs_ex is not None:
                    if abs_ex <= now:
                        fn(*args, **kw)
                        self._data.pop(args[0], None)
                        self._expiry.pop(args[0], None)
                        continue
                    kw["ex"] = abs_ex - now
                fn(*args, **kw)

    def _compact(self) -> None:
        """Rewrite the journal as the minimal op sequence reconstructing the
        current state, atomically (tmp + rename)."""
        if self._persist_path is None:
            return
        with self._lock:
            if self._journal is not None:
                self._journal.close()
                self._journal = None
            tmp = self._persist_path + ".tmp"
            now = self._time()
            with open(tmp, "w") as f:
                for key in list(self._data):
                    if self._expired(key):
                        continue
                    val = self._data[key]
                    if isinstance(val, str):
                        f.write(json.dumps({"m": "set", "a": [key, val]}) + "\n")
                    elif isinstance(val, set):
                        f.write(json.dumps({"m": "sadd", "a": [key, *sorted(val)]}) + "\n")
                    elif isinstance(val, list):
                        f.write(json.dumps({"m": "rpush", "a": [key, *val]}) + "\n")
                    elif isinstance(val, dict):
                        # hashes hold str values, zsets hold floats
                        if val and isinstance(next(iter(val.values())), float):
                            f.write(json.dumps({"m": "zadd", "a": [key, val]}) + "\n")
                        else:
                            f.write(
                                json.dumps({"m": "hset_mapping", "a": [key, val]})
                                + "\n"
                            )
                    exp = self._expiry.get(key)
                    if exp is not None:
                        f.write(
                            json.dumps({"m": "expire", "a": [key], "abs": exp}) + "\n"
                        )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._persist_path)
            self._journal = open(self._persist_path, "a", buffering=1)
            self._journal_ops = 0

    def close(self) -> None:
        with self._lock:
            if self._journal is not None:
                self._compact()
                self._journal.close()
                self._journal = None
                self._persist_path = None

    # ------------- internals -------------

    def _expired(self, key: str) -> bool:
        exp = self._expiry.get(key)
        if exp is not None and self._time() >= exp:
            self._data.pop(key, None)
            self._expiry.pop(key, None)
            return True
        return False

    def _get_typed(self, key: str, typ: type, create: bool = False):
        if self._expired(key):
            val = None
        else:
            val = self._data.get(key)
        if val is None:
            if not create:
                return None
            val = typ()
            self._data[key] = val
            self._expiry.pop(key, None)
        if not isinstance(val, typ):
            raise TypeError(f"WRONGTYPE key {key!r} holds {type(val).__name__}")
        return val

    # ------------- strings -------------

    @_journaled
    def set(
        self,
        key: str,
        value: str,
        *,
        # keyword-only: _journal_append rewrites the ex TTL to an absolute
        # deadline by kwarg name — a positional TTL would journal raw and
        # replay relative to RESTART time, extending expirations
        nx: bool = False,
        ex: Optional[float] = None,
    ) -> bool:
        with self._lock:
            self._expired(key)
            if nx and key in self._data:
                return False
            self._data[key] = str(value)
            if ex is not None:
                self._expiry[key] = self._time() + ex
            else:
                self._expiry.pop(key, None)
            return True

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            v = self._get_typed(key, str)
            return v

    def mget(self, keys: Iterable[str]) -> list[Optional[str]]:
        with self._lock:
            return [self._get_typed(k, str) for k in keys]

    @_journaled
    def incr(self, key: str, amount: int = 1) -> int:
        with self._lock:
            cur = self._get_typed(key, str)
            val = int(cur) + amount if cur is not None else amount
            self._data[key] = str(val)
            return val

    @_journaled
    def delete(self, *keys: str) -> int:
        with self._lock:
            n = 0
            for key in keys:
                self._expired(key)
                if key in self._data:
                    del self._data[key]
                    self._expiry.pop(key, None)
                    n += 1
            return n

    def exists(self, key: str) -> bool:
        with self._lock:
            self._expired(key)
            return key in self._data

    @_journaled
    def expire(self, key: str, seconds: float) -> bool:
        with self._lock:
            self._expired(key)
            if key not in self._data:
                return False
            self._expiry[key] = self._time() + seconds
            return True

    def ttl(self, key: str) -> Optional[float]:
        """Remaining TTL; None if no key or no expiry."""
        with self._lock:
            self._expired(key)
            if key not in self._data:
                return None
            exp = self._expiry.get(key)
            return None if exp is None else max(0.0, exp - self._time())

    def keys(self, pattern: str = "*") -> list[str]:
        with self._lock:
            return [k for k in list(self._data) if not self._expired(k) and fnmatch.fnmatch(k, pattern)]

    @_journaled
    def flushall(self) -> None:
        with self._lock:
            self._data.clear()
            self._expiry.clear()

    # ------------- hashes -------------

    @_journaled
    def hset(self, key: str, field: str, value: str) -> int:
        with self._lock:
            h = self._get_typed(key, dict, create=True)
            is_new = field not in h
            h[field] = str(value)
            return int(is_new)

    @_journaled
    def hset_mapping(self, key: str, mapping: dict[str, str]) -> int:
        with self._lock:
            h = self._get_typed(key, dict, create=True)
            n = sum(1 for f in mapping if f not in h)
            h.update({f: str(v) for f, v in mapping.items()})
            return n

    def hget(self, key: str, field: str) -> Optional[str]:
        with self._lock:
            h = self._get_typed(key, dict)
            return None if h is None else h.get(field)

    def hgetall(self, key: str) -> dict[str, str]:
        with self._lock:
            h = self._get_typed(key, dict)
            return dict(h) if h else {}

    @_journaled
    def hdel(self, key: str, *fields: str) -> int:
        with self._lock:
            h = self._get_typed(key, dict)
            if not h:
                return 0
            n = 0
            for f in fields:
                if f in h:
                    del h[f]
                    n += 1
            if not h:
                self.delete(key)
            return n

    @_journaled
    def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        with self._lock:
            h = self._get_typed(key, dict, create=True)
            val = int(h.get(field, "0")) + amount
            h[field] = str(val)
            return val

    # ------------- sets -------------

    @_journaled
    def sadd(self, key: str, *members: str) -> int:
        with self._lock:
            s = self._get_typed(key, set, create=True)
            n = len(members) - len(s.intersection(members))
            s.update(str(m) for m in members)
            return n

    @_journaled
    def srem(self, key: str, *members: str) -> int:
        with self._lock:
            s = self._get_typed(key, set)
            if not s:
                return 0
            n = len(s.intersection(members))
            s.difference_update(members)
            if not s:
                self.delete(key)
            return n

    def smembers(self, key: str) -> set[str]:
        with self._lock:
            s = self._get_typed(key, set)
            return set(s) if s else set()

    def sismember(self, key: str, member: str) -> bool:
        with self._lock:
            s = self._get_typed(key, set)
            return bool(s) and member in s

    def scard(self, key: str) -> int:
        with self._lock:
            s = self._get_typed(key, set)
            return len(s) if s else 0

    # ------------- sorted sets -------------

    @_journaled
    def zadd(self, key: str, mapping: dict[str, float]) -> int:
        with self._lock:
            z = self._get_typed(key, dict, create=True)
            n = sum(1 for m in mapping if m not in z)
            z.update({str(m): float(s) for m, s in mapping.items()})
            return n

    def zscore(self, key: str, member: str) -> Optional[float]:
        with self._lock:
            z = self._get_typed(key, dict)
            return None if z is None else z.get(member)

    @_journaled
    def zrem(self, key: str, *members: str) -> int:
        with self._lock:
            z = self._get_typed(key, dict)
            if not z:
                return 0
            n = 0
            for m in members:
                if m in z:
                    del z[m]
                    n += 1
            if not z:
                self.delete(key)
            return n

    def zrangebyscore(
        self, key: str, min_score: float = float("-inf"), max_score: float = float("inf")
    ) -> list[tuple[str, float]]:
        with self._lock:
            z = self._get_typed(key, dict)
            if not z:
                return []
            out = [(m, s) for m, s in z.items() if min_score <= s <= max_score]
            out.sort(key=lambda ms: (ms[1], ms[0]))
            return out

    @_journaled
    def zremrangebyscore(self, key: str, min_score: float, max_score: float) -> int:
        with self._lock:
            victims = [m for m, _ in self.zrangebyscore(key, min_score, max_score)]
            return self.zrem(key, *victims) if victims else 0

    def zcard(self, key: str) -> int:
        with self._lock:
            z = self._get_typed(key, dict)
            return len(z) if z else 0

    # ------------- lists -------------

    @_journaled
    def rpush(self, key: str, *values: str) -> int:
        with self._lock:
            lst = self._get_typed(key, list, create=True)
            lst.extend(str(v) for v in values)
            return len(lst)

    @_journaled
    def lpush(self, key: str, *values: str) -> int:
        with self._lock:
            lst = self._get_typed(key, list, create=True)
            for v in values:
                lst.insert(0, str(v))
            return len(lst)

    def lrange(self, key: str, start: int = 0, stop: int = -1) -> list[str]:
        with self._lock:
            lst = self._get_typed(key, list)
            if not lst:
                return []
            if stop == -1:
                return list(lst[start:])
            return list(lst[start : stop + 1])

    @_journaled
    def lrem(self, key: str, count: int, value: str) -> int:
        """Redis LREM semantics for count >= 0 (remove first `count`
        occurrences; 0 = all)."""
        with self._lock:
            lst = self._get_typed(key, list)
            if not lst:
                return 0
            removed = 0
            out = []
            for v in lst:
                if v == value and (count == 0 or removed < count):
                    removed += 1
                    continue
                out.append(v)
            if out:
                self._data[key] = out
            else:
                self.delete(key)
            return removed

    def llen(self, key: str) -> int:
        with self._lock:
            lst = self._get_typed(key, list)
            return len(lst) if lst else 0

    # ------------- atomic batches -------------

    def atomic(self):
        """Context manager holding the store lock across a multi-op batch —
        the moral equivalent of the reference's Redis pipelines and Lua
        scripts for group create/dissolve/merge atomicity
        (node_groups/mod.rs:298-322)."""
        return self._lock

    def pipeline_execute(self, ops: list) -> list:
        """Execute [(op, args, kwargs), ...] under one lock, returning each
        op's result — the Redis pipeline shape (one round trip over the
        remote client). Like a Redis pipeline, this is ISOLATED but not
        transactional: ops apply in order and a failing op aborts the
        remainder with earlier ops committed — batch only ops whose
        validity is guaranteed by construction."""
        out = []
        with self._lock:
            for op, args, kwargs in ops:
                out.append(getattr(self, op)(*args, **(kwargs or {})))
        return out


class RemoteKVError(RuntimeError):
    """An op of a store behind the wire failed (``protocol_tpu/store/
    remote_kv.py:23``; the remote client is ROADMAP queue A, M4c)."""


class LockLostError(RemoteKVError):
    """The advisory lock an atomic section held expired (and may have been
    taken by another client), so the op did not execute: callers retry
    the whole section, not the op (``protocol_tpu/store/remote_kv.py:27``).
    Only a remote store raises it; the orchestrator's sections keep the
    reference's retry."""
