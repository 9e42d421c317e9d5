"""LRU memo of completed SSSP rows: ``(graph_key, criterion, source) -> dist``
(counterpart of ``repro.serving.cache``: the same keys and the same
``REPRODC1`` snapshot framing, so a snapshot written by either package
restores in the other).

The serving workload ("millions of users, one road network") repeats
sources heavily — popular origins recur across requests — and a completed
``(n,)`` distance row is immutable, so a duplicate query can be answered
without occupying a lane at all. The cache is keyed by a *content* hash of
the graph (not object identity): two :class:`~repro_torch.core.graph.Graph`
instances holding the same COO arrays share entries, and any change to the
edge set or weights changes the key, so stale answers cannot leak across
graph versions.

The *criterion* is part of the key since criteria became pluggable: two
backends over the same graph but different criteria agree only in exact
arithmetic — their float relaxation orders differ — so sharing rows across
criteria would break the "a served answer is bitwise an engine answer for
this backend" contract (and any test pinning it). Callers pass the
backend's canonical criterion string.

Entries are host ``numpy`` arrays marked read-only (a cache hit hands out
the stored array; copying n floats per hit would defeat the point, and the
writeable flag turns accidental in-place mutation of a shared answer into a
loud error).

Robustness (DESIGN.md Sec. 14): every entry carries a CRC32 of its row
bytes, verified on each ``get`` — a row that rotted in memory (or was
poisoned) is dropped and the lookup counts
as a miss, so corruption is re-solved, never served. Entries are also
timestamped; a server configured with a TTL treats older rows as misses
unless the request marked staleness acceptable. :meth:`DistCache.snapshot`
/ :meth:`DistCache.restore` persist the cache across process restarts:
the snapshot is written to a temp file and atomically renamed into place
(a crash mid-save leaves the previous snapshot intact), and restore
tolerates truncated, bit-flipped, or foreign files by loading only the
entries whose framing and checksum both verify.
"""
from __future__ import annotations

import hashlib
import json
import os
import zlib
from collections import OrderedDict

import numpy as np

from repro_torch.core.graph import Graph

# Snapshot framing: magic, then per entry a 4-byte LE meta length, a UTF-8
# JSON meta dict, and the raw row bytes. The version byte is part of the
# magic: a future format bump makes old readers reject cleanly.
SNAPSHOT_MAGIC = b"REPRODC1"
_META_MAX = 1 << 20  # sanity bound: a meta blob larger than 1 MiB is garbage


def graph_key(g: Graph) -> str:
    """Content hash of a graph's edge structure (memoised per instance).

    Hashes ``n`` and ``m`` as int64, then the COO arrays ``src``, ``dst``,
    ``w`` (padding included: padding is +inf-weight no-ops, so equal
    content implies equal engine behaviour) and the per-vertex static
    minima, in the reference's dtypes (int32, int32, f32, f32, f32) and
    order, so the key equals the reference's for the same COO. The minima
    are hashed because ``Graph`` accepts them as independent inputs and the
    settle criterion reads them. Each array is copied to the host once, one
    at a time (~1.2 GB in all on G(10^6, 10^-4)); the key is stored in the
    instance ``__dict__`` like the ELL memo.
    """
    cached = g.__dict__.get("_graph_key")
    if cached is not None:
        return cached
    h = hashlib.sha1()
    h.update(np.int64(g.n).tobytes())
    h.update(np.int64(g.m).tobytes())
    for a, dtype in ((g.src, np.int32), (g.dst, np.int32), (g.w, np.float32),
                     (g.in_min_static, np.float32),
                     (g.out_min_static, np.float32)):
        host = np.ascontiguousarray(a.cpu().numpy(), dtype=dtype)
        h.update(host.tobytes())
    key = h.hexdigest()
    g.__dict__["_graph_key"] = key
    return key


class _Entry:
    """One cached row plus its integrity/staleness metadata."""

    __slots__ = ("row", "crc", "t")

    def __init__(self, row: np.ndarray, crc: int, t: float):
        self.row = row
        self.crc = crc
        self.t = t


class DistCache:
    """Bounded LRU of completed distance rows (checksummed, persistable)."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self._d: OrderedDict[tuple[str, str, int], _Entry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.corrupt_dropped = 0  # entries whose CRC failed on get/restore
        self.stale_misses = 0  # lookups that found only a too-old row

    def get(self, gkey: str, criterion: str, source: int,
            now: float = 0.0, max_age: float | None = None) -> np.ndarray | None:
        """The stored row, or None (a miss) — and the one place corruption
        and staleness are decided, so hit/miss stats stay classification-
        exact for the scheduler's "each arrival consults the cache once"
        invariant. A CRC mismatch drops the entry (re-solve refills it); a
        row older than ``max_age`` stays cached (a later ``stale_ok``
        lookup passes ``max_age=None`` and may still use it) but counts as
        a miss here."""
        key = (gkey, criterion, int(source))
        e = self._d.get(key)
        if e is None:
            self.misses += 1
            return None
        if zlib.crc32(e.row.tobytes()) != e.crc:
            # in-memory rot (or injected poison): the row can no longer be
            # trusted — drop it so the re-solve repopulates a clean copy
            del self._d[key]
            self.corrupt_dropped += 1
            self.misses += 1
            return None
        if max_age is not None and (now - e.t) > max_age:
            self.stale_misses += 1
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return e.row

    def age(self, gkey: str, criterion: str, source: int,
            now: float) -> float | None:
        """Age of a cached row in clock units (None if absent). Pure
        introspection: no LRU movement, no hit/miss accounting."""
        e = self._d.get((gkey, criterion, int(source)))
        return None if e is None else now - e.t

    def put(self, gkey: str, criterion: str, source: int,
            dist: np.ndarray, now: float = 0.0) -> None:
        key = (gkey, criterion, int(source))
        row = np.asarray(dist)
        if key in self._d:  # identical content by construction: refresh
            self._d[key].t = float(now)  # recency AND staleness clock
            self._d.move_to_end(key)
            return
        row = row.copy()
        row.flags.writeable = False
        self._d[key] = _Entry(row, zlib.crc32(row.tobytes()), float(now))
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: tuple[str, str, int]) -> bool:
        return (key[0], key[1], int(key[2])) in self._d

    # -- crash-safe persistence ---------------------------------------------

    def snapshot(self, path: str) -> int:
        """Atomically persist every entry; returns the count written.

        The file is written to a sibling temp path and ``os.replace``d into
        place, so a crash at any byte leaves either the old snapshot or the
        new one — never a half-written file at ``path``. Entries stream out
        oldest-first so a restore rebuilds the same LRU order.
        """
        tmp = f"{path}.tmp.{os.getpid()}"
        count = 0
        try:
            with open(tmp, "wb") as f:
                f.write(SNAPSHOT_MAGIC)
                for (gkey, criterion, source), e in self._d.items():
                    raw = e.row.tobytes()
                    meta = json.dumps({
                        "gkey": gkey, "criterion": criterion,
                        "source": int(source), "dtype": str(e.row.dtype),
                        "shape": list(e.row.shape), "crc": int(e.crc),
                        "nbytes": len(raw), "t": float(e.t),
                    }).encode("utf-8")
                    f.write(len(meta).to_bytes(4, "little"))
                    f.write(meta)
                    f.write(raw)
                    count += 1
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return count

    def restore(self, path: str, now: float = 0.0) -> int:
        """Load entries from a snapshot; returns how many were accepted.

        Tolerant by construction: a missing file or foreign magic loads
        nothing; a truncated tail keeps every entry before the cut; an
        entry whose stored CRC disagrees with its bytes is skipped (counted
        in ``corrupt_dropped``) and the scan continues at the next frame.
        Restored rows keep their snapshot timestamps shifted so ages are
        measured from ``now`` (a restart must not make every row look
        fresh *or* ancient under a TTL).
        """
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            return 0
        loaded = 0
        with f:
            if f.read(len(SNAPSHOT_MAGIC)) != SNAPSHOT_MAGIC:
                return 0
            t_latest = None
            pending: list[tuple[tuple[str, str, int], np.ndarray, int, float]] = []
            while True:
                head = f.read(4)
                if len(head) < 4:
                    break  # clean EOF or truncated length: stop
                mlen = int.from_bytes(head, "little")
                if not 0 < mlen <= _META_MAX:
                    break  # framing is garbage: nothing past here is safe
                mraw = f.read(mlen)
                if len(mraw) < mlen:
                    break
                try:
                    meta = json.loads(mraw.decode("utf-8"))
                    nbytes = int(meta["nbytes"])
                    key = (str(meta["gkey"]), str(meta["criterion"]),
                           int(meta["source"]))
                    dtype = np.dtype(meta["dtype"])
                    shape = tuple(int(s) for s in meta["shape"])
                    crc = int(meta["crc"])
                    t = float(meta["t"])
                except (ValueError, KeyError, TypeError):
                    break  # can't trust the frame length either: stop
                raw = f.read(nbytes)
                if len(raw) < nbytes:
                    break  # truncated row: drop it, keep what we have
                if zlib.crc32(raw) != crc:
                    self.corrupt_dropped += 1
                    continue  # bit rot in this entry only: skip, carry on
                try:
                    row = np.frombuffer(raw, dtype=dtype).reshape(shape)
                except ValueError:
                    self.corrupt_dropped += 1
                    continue
                pending.append((key, row, crc, t))
                t_latest = t if t_latest is None else max(t_latest, t)
        for key, row, crc, t in pending:
            row = row.copy()
            row.flags.writeable = False
            # preserve relative ages: the newest snapshot entry restores at
            # age 0 from `now`, older ones proportionally older
            age = 0.0 if t_latest is None else t_latest - t
            self._d[key] = _Entry(row, crc, float(now) - age)
            self._d.move_to_end(key)
            loaded += 1
            if len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self.evictions += 1
        return loaded
