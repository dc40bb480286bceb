"""Pluggable solve-memo backends: the ``CacheBackend`` protocol.

``ExecutionContext.cache`` used to be hard-wired to
:class:`~repro_torch.core.solver.SolveCache`; it now accepts anything implementing
:class:`CacheBackend` — the structural protocol below.  Two implementations
ship:

* :class:`~repro_torch.core.solver.SolveCache` — in-process bounded LRU (the
  default; unchanged semantics);
* :class:`JsonlCacheBackend` — the same LRU plus an append-only JSONL
  journal on disk, so a restarted serving fleet rewarms its memo from prior
  runs instead of re-solving every cartridge from scratch.

Every backend memoises *exact* results keyed by the canonicalized request
multiset plus the result-affecting execution fingerprint (see the
:mod:`repro_torch.core.solver` docstring for the key layout), so swapping
backends — or bounding one below the working set — can change wall time but
never a schedule.

Warm states (:class:`~repro_torch.core.warm.WarmState`) ride alongside via
``get_warm``/``put_warm``.  They are advisory accelerators, not results:
losing one costs extra DP cell evaluations on the next solve, never
correctness, and they hold live table references — so the JSONL backend
journals only the solve memo.  A restarted fleet rewarms through the
persisted *solves* (a memo hit does zero DP work, which beats any warm
start), and rebuilds warm states on its first post-restart miss per
cartridge.

JSONL journal format: one object per line, ``{"k": [...], "cost": int,
"det": [[c, b], ...]}`` with byte-valued key fields hex-encoded.  Appends
are flushed per put; loading replays the journal in order (later lines win)
into the LRU, and :meth:`JsonlCacheBackend.compact` rewrites the file to
the live entries when restarts have piled up superseded lines.
"""

from __future__ import annotations

import json
import os
from typing import Protocol, runtime_checkable

from .instance import Instance
from .solver import SolveCache, SolveResult

__all__ = ["CacheBackend", "CacheLockedError", "JsonlCacheBackend"]


class CacheLockedError(RuntimeError):
    """Another live writer already owns this cache journal path.

    Two concurrent appenders would interleave half-lines and tear the
    journal, so :class:`JsonlCacheBackend` takes a sidecar lockfile on
    construction and refuses a second writer — in this process (a backend
    not yet :meth:`~JsonlCacheBackend.close`\\ d) or in another live one.  A
    lockfile left behind by a dead process (stale pid) is taken over
    silently.
    """

    def __init__(self, path: str, pid: int):
        self.path = path
        self.pid = pid
        super().__init__(
            f"cache journal {path!r} is already open for writing by live "
            f"process {pid}; close() the other backend first"
        )


def _pid_alive(pid: int) -> bool:
    """Best-effort liveness probe (signal 0; EPERM still means alive)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True
    return True


#: journal paths (absolute) held open for writing by this process; guards
#: the same-process two-writer case the pid probe cannot distinguish.
_OPEN_JOURNALS: set[str] = set()


@runtime_checkable
class CacheBackend(Protocol):
    """Structural protocol every solve-memo backend implements.

    ``numeric_policy``/``cand_tile`` default to the
    :data:`~repro_torch.core.context.DEFAULT_CONTEXT` values so pre-protocol
    call sites (``cache.get(inst, policy, backend)``) keep working.
    """

    def get(
        self,
        inst: Instance,
        policy: str,
        backend: str,
        numeric_policy: str = "strict",
        cand_tile: int | None = None,
    ) -> SolveResult | None:
        """The memoised result for this key, or ``None`` (counts a miss)."""

    def put(
        self,
        inst: Instance,
        policy: str,
        backend: str,
        res: SolveResult,
        numeric_policy: str = "strict",
        cand_tile: int | None = None,
    ) -> None:
        """Memoise ``res`` under this key (evicting LRU entries if bounded)."""

    def get_warm(self, key: tuple):
        """The stored warm state for ``key``, or ``None`` (advisory)."""

    def put_warm(self, key: tuple, state) -> None:
        """Store an advisory warm state under ``key``."""

    def stats(self) -> dict[str, int]:
        """At least ``hits``/``misses``/``entries`` counters."""

    def clear(self) -> None:
        """Drop every entry and reset the counters."""

    def __len__(self) -> int:
        """Number of memoised solve entries."""


class JsonlCacheBackend(SolveCache):
    """:class:`SolveCache` journaled to an append-only JSONL file.

    Construction replays an existing journal into the in-memory LRU
    (most-recent line wins), so a serving fleet restarted against the same
    path starts with its previous memo hot.  Every :meth:`put` appends one
    line and flushes — crash-safe up to the last completed write; a torn
    final line is skipped on load.  Entries evicted from the bounded LRU
    stay in the journal (append-only) and revive on the next restart;
    :meth:`compact` rewrites the file down to the currently-live entries.
    """

    def __init__(self, path: str | os.PathLike, maxsize: int = 4096,
                 warm_maxsize: int = 512):
        super().__init__(maxsize=maxsize, warm_maxsize=warm_maxsize)
        self.path = os.fspath(path)
        self._locked = False
        self._acquire_lock()
        self.loaded = 0
        if os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        row = json.loads(line)
                        key = self._decode_key(row["k"])
                        entry = (
                            int(row["cost"]),
                            tuple((int(c), int(b)) for c, b in row["det"]),
                        )
                    except (ValueError, KeyError, TypeError):
                        continue  # torn/foreign line: skip, stay usable
                    self._store[key] = entry
                    self._store.move_to_end(key)
                    self.loaded += 1
            while len(self._store) > self.maxsize:
                self._store.popitem(last=False)
        self._fh = open(self.path, "a", encoding="utf-8")

    # -- key <-> JSON (bytes fields hex-encoded) ------------------------------
    @staticmethod
    def _encode_key(key: tuple) -> list:
        return [v.hex() if isinstance(v, bytes) else v for v in key]

    @staticmethod
    def _decode_key(fields: list) -> tuple:
        # positional layout from SolveCache.key: the last three fields are
        # the hex-encoded left/right/mult array bytes
        head = [tuple(v) if isinstance(v, list) else v for v in fields[:-3]]
        return tuple(head) + tuple(bytes.fromhex(v) for v in fields[-3:])

    def put(
        self,
        inst: Instance,
        policy: str,
        backend: str,
        res: SolveResult,
        numeric_policy: str = "strict",
        cand_tile: int | None = None,
    ) -> None:
        super().put(inst, policy, backend, res, numeric_policy, cand_tile)
        key = self.key(inst, policy, backend, numeric_policy, cand_tile)
        row = {
            "k": self._encode_key(key),
            "cost": res.cost,
            "det": [[int(c), int(b)] for c, b in res.detours],
        }
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def compact(self) -> None:
        """Rewrite the journal to the live LRU entries (oldest first).

        Crash-safe: the replacement journal is staged in a temp file that is
        flushed and fsynced *before* the atomic ``os.replace``, so a process
        killed at any point leaves either the old journal or the new one on
        disk — never a torn mix.  The append handle is reopened in a
        ``finally`` block, so a failure mid-stage leaves the backend usable
        (and the old journal intact).
        """
        self._fh.close()
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                for key, (cost, det) in self._store.items():
                    fh.write(json.dumps({
                        "k": self._encode_key(key),
                        "cost": cost,
                        "det": [list(d) for d in det],
                    }) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        finally:
            self._fh = open(self.path, "a", encoding="utf-8")

    def clear(self) -> None:
        super().clear()
        self._fh.close()
        open(self.path, "w", encoding="utf-8").close()
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        self._fh.close()
        self._release_lock()

    def stats(self) -> dict[str, int]:
        return {**super().stats(), "loaded": self.loaded}

    # -- single-writer lockfile ------------------------------------------------
    # Shards of a serving fleet may share one persistent memo *object*, but
    # two independent appenders on one journal file would interleave torn
    # lines.  The lock is a sidecar ``<path>.lock`` holding the writer's pid:
    # construction refuses when the pid is a live foreign process or the path
    # is already open in this process; a dead pid (or corrupt lockfile) is
    # stale and taken over.
    @property
    def _lock_path(self) -> str:
        return self.path + ".lock"

    def _acquire_lock(self) -> None:
        key = os.path.abspath(self.path)
        if key in _OPEN_JOURNALS:
            raise CacheLockedError(self.path, os.getpid())
        if os.path.exists(self._lock_path):
            try:
                with open(self._lock_path, encoding="utf-8") as fh:
                    pid = int(fh.read().strip())
            except (ValueError, OSError):
                pid = None  # corrupt/unreadable lockfile: stale
            if pid is not None and pid != os.getpid() and _pid_alive(pid):
                raise CacheLockedError(self.path, pid)
            # stale: dead owner, corrupt file, or a leaked same-process
            # handle that was never close()d (not registered above)
        with open(self._lock_path, "w", encoding="utf-8") as fh:
            fh.write(f"{os.getpid()}\n")
            fh.flush()
        _OPEN_JOURNALS.add(key)
        self._locked = True

    def _release_lock(self) -> None:
        if not self._locked:
            return
        self._locked = False
        _OPEN_JOURNALS.discard(os.path.abspath(self.path))
        try:
            os.remove(self._lock_path)
        except OSError:
            pass
