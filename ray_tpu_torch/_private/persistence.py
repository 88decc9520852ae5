"""Control-store persistence: pluggable snapshot + write-ahead-log backends.

Capability parity with the reference's GCS store clients (reference:
src/ray/gcs/store_client/redis_store_client.h, in_memory_store_client.h and
the RAY_external_storage_namespace recovery flow): the control store appends
every table mutation to a WAL and periodically compacts into a snapshot; a
restarted (or warm-standby) control store replays snapshot + WAL and resumes
serving with nodes, actors, placement groups, jobs, and KV intact.

The storage layer is a pluggable backend selected by the
`control_store_backend` flag:

  file    (default) `snapshot.msgpack` (atomic whole-state) + `wal.msgpack`
          (appended msgpack records) in `<dir>/` — the original format.
  sqlite  one `store.sqlite3` holding a `wal` table (seq-keyed records), a
          `snap` table, and a `meta` table carrying the fence epoch — the
          rocksdb-style embedded-KV shape of the reference's store clients.

Every record is stamped with a monotonic sequence number `i` (resumed across
restarts/failovers) and every snapshot carries `_wal_seq`, the seq of the
last folded record. Those stamps are what make two HA mechanisms exact:

  * warm-standby tailing (`open_tailer`): a standby replays the WAL as it
    grows — duplicates from compaction rotations dedup by seq, and a seq
    GAP (records compacted away before the tailer saw them) tells the
    standby to re-seed from the snapshot.
  * epoch fencing (`FencedError`): each leader opens the store with a
    fencing epoch from the leadership lease. A zombie primary that lost
    leadership cannot apply a late mutation — the sqlite backend refuses
    appends from a stale epoch in the INSERT itself; the file backend's
    appends check the EPOCH stamp a new leader writes before reading the
    WAL, and the takeover compaction unlinks the zombie's WAL inode so
    even a stamp-racing append lands in a file nobody will read.
"""

from __future__ import annotations

import logging
import os
import sqlite3
from typing import Optional

import msgpack

logger = logging.getLogger(__name__)

SNAPSHOT = "snapshot.msgpack"
WAL = "wal.msgpack"
WAL_OLD = "wal.old.msgpack"
SQLITE_DB = "store.sqlite3"
EPOCH_FILE = "EPOCH"

# snapshot key carrying the seq of the last record folded into it
SNAP_SEQ_KEY = "_wal_seq"
# record key carrying the monotonic sequence stamp
REC_SEQ_KEY = "i"


class FencedError(RuntimeError):
    """This writer's fencing epoch was superseded: another control store
    took over leadership. The only safe reaction is to stop serving — a
    fenced primary must not apply (or ack) another mutation."""


def _valid_record(rec) -> bool:
    # a torn/corrupt tail can decode to SOME msgpack value (e.g. a stray
    # int); only a dict shaped like a WAL record counts — anything else
    # ends the valid log
    return isinstance(rec, dict) and "op" in rec and "d" in rec


def _read_records(path: str) -> list:
    records = []
    if os.path.exists(path):
        with open(path, "rb") as f:
            unpacker = msgpack.Unpacker(f, raw=False, strict_map_key=False)
            while True:
                try:
                    rec = next(unpacker)
                except StopIteration:
                    break
                except Exception:  # noqa: BLE001 — torn tail record
                    logger.warning(
                        "dropping torn WAL tail after %d records (%s)",
                        len(records), path,
                    )
                    break
                if not _valid_record(rec):
                    logger.warning(
                        "dropping malformed WAL tail after %d records (%s)",
                        len(records), path,
                    )
                    break
                records.append(rec)
    return records


def read_epoch(directory: str) -> int:
    """Highest fencing epoch that ever opened this persist dir (0 = none)."""
    try:
        with open(os.path.join(directory, EPOCH_FILE)) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def _write_epoch(directory: str, epoch: int) -> None:
    tmp = os.path.join(directory, f".epoch.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(str(epoch))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, EPOCH_FILE))


# ---------------------------------------------------------------------------
# file backend (the original format)
# ---------------------------------------------------------------------------


class FileBackend:
    """msgpack files: `snapshot.msgpack` + `wal.msgpack` (+ `wal.old` during
    two-phase compaction). Fencing: a new leader stamps the EPOCH file at
    open (before reading the WAL) — a zombie's appends check it and raise
    FencedError; the takeover compaction additionally folds and unlinks the
    zombie's WAL inode, so even an append that races the stamp lands in a
    file the new leader will never read."""

    name = "file"

    def __init__(self, directory: str, epoch: int = 0):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._wal_path = os.path.join(directory, WAL)
        self._wal_old_path = os.path.join(directory, WAL_OLD)
        self._snap_path = os.path.join(directory, SNAPSHOT)
        self._wal_file = None
        self.epoch = epoch
        if epoch:
            recorded = read_epoch(directory)
            if recorded > epoch:
                raise FencedError(
                    f"persist dir {directory} already fenced at epoch "
                    f"{recorded} > {epoch}")
            if recorded < epoch:
                _write_epoch(directory, epoch)

    def recover(self) -> tuple:
        snap = None
        if os.path.exists(self._snap_path):
            try:
                with open(self._snap_path, "rb") as f:
                    # raw=False: str↔str, bytes(bin)↔bytes — exact round-trip
                    # of the wire-dict convention; bytes map keys allowed.
                    snap = msgpack.unpackb(
                        f.read(), raw=False, strict_map_key=False)
            except Exception:  # noqa: BLE001 — corrupt snapshot: start empty
                logger.exception("snapshot unreadable; recovering from WAL only")
        records = _read_records(self._wal_old_path) + _read_records(self._wal_path)
        return snap, records

    def _wal(self):
        if self._wal_file is None:
            self._wal_file = open(self._wal_path, "ab")
        return self._wal_file

    def append(self, record: dict) -> None:
        f = self._wal()
        if self.epoch:
            # two fencing probes, both BEFORE the write is acked. (1) The
            # inode at the WAL path vs our open handle: the active leader
            # always writes to the path's inode (rotate closes the handle;
            # the next append reopens) — a mismatch or missing path means
            # a takeover rotated our file away. (2) The EPOCH stamp a new
            # leader writes before it READS the WAL — this closes the
            # pre-rotate window exactly: an append that passed the check
            # before the stamp landed is included in the new leader's
            # recovery (so its ack is honest), and one after it is
            # refused, never acked. The small-file read is noise next to
            # the pack+write+flush it gates, and persisted mutations are
            # orders of magnitude rarer than heartbeats.
            try:
                if os.stat(self._wal_path).st_ino \
                        != os.fstat(f.fileno()).st_ino:
                    raise FencedError(
                        f"WAL rotated away by a newer leader (epoch "
                        f"{self.epoch} superseded); append refused")
            except FileNotFoundError:
                raise FencedError(
                    f"WAL unlinked by a newer leader (epoch {self.epoch} "
                    f"superseded); append refused") from None
            recorded = read_epoch(self.dir)
            if recorded > self.epoch:
                raise FencedError(
                    f"epoch {self.epoch} superseded by {recorded}; "
                    f"append refused")
        f.write(msgpack.packb(record))
        f.flush()
        if self.epoch and read_epoch(self.dir) > self.epoch:
            # the stamp landed BETWEEN our probe and the flush: the new
            # leader's recovery may or may not have read this record, so
            # the only honest answer is an error — the caller's retry
            # lands on the new incumbent, whose mutations are idempotent
            raise FencedError(
                f"epoch {self.epoch} superseded mid-append; ack refused")

    def rotate(self) -> None:
        """Freeze the current WAL as wal.old (cheap rename; event-loop
        safe). New appends go to a fresh WAL. If a previous compaction
        failed, its un-folded wal.old is still live state — merge instead of
        clobbering it."""
        if self._wal_file is not None:
            self._wal_file.close()
            self._wal_file = None
        if os.path.exists(self._wal_path):
            if os.path.exists(self._wal_old_path):
                with open(self._wal_old_path, "ab") as dst, \
                        open(self._wal_path, "rb") as src:
                    dst.write(src.read())
                os.unlink(self._wal_path)
            else:
                os.replace(self._wal_path, self._wal_old_path)

    def write_snapshot(self, state: dict) -> None:
        """Pack + fsync + atomically install the snapshot, then drop wal.old
        (its records are folded in). Safe to run on a worker thread."""
        if self.epoch and read_epoch(self.dir) > self.epoch:
            raise FencedError(
                f"epoch {self.epoch} superseded; refusing snapshot")
        tmp = self._snap_path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(state))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        try:
            os.unlink(self._wal_old_path)
        except OSError:
            pass

    def close(self) -> None:
        if self._wal_file is not None:
            self._wal_file.close()
            self._wal_file = None


class FileTailer:
    """Warm-standby tail of a FileBackend dir: poll() yields records as the
    leader appends them. Holds file handles across compaction rotations
    (renames keep the inode; merge-rotations only copy already-seen bytes,
    deduped by seq upstream), so no record is ever missed."""

    def __init__(self, directory: str):
        self.dir = directory
        self._wal_path = os.path.join(directory, WAL)
        self._wal_old_path = os.path.join(directory, WAL_OLD)
        # creation-ordered open inodes: [(inode, fh, unpacker)]
        self._streams: list = []
        self._known_inodes: set = set()

    def read_snapshot(self) -> Optional[dict]:
        path = os.path.join(self.dir, SNAPSHOT)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                return msgpack.unpackb(f.read(), raw=False,
                                       strict_map_key=False)
        except Exception:  # noqa: BLE001 — mid-replace read; next poll
            return None

    def _open_new(self):
        # wal.old first (older records), then wal
        for path in (self._wal_old_path, self._wal_path):
            try:
                st = os.stat(path)
            except OSError:
                continue
            if st.st_ino in self._known_inodes:
                continue
            try:
                fh = open(path, "rb")
            except OSError:
                continue
            if os.fstat(fh.fileno()).st_ino != st.st_ino:
                # path re-pointed between stat and open; retry next poll
                fh.close()
                continue
            self._known_inodes.add(st.st_ino)
            self._streams.append((
                st.st_ino, fh,
                msgpack.Unpacker(raw=False, strict_map_key=False),
            ))

    def poll(self) -> list:
        """All complete records appended since the last poll, oldest first.
        A torn tail (leader mid-write, or killed mid-write) stays buffered
        until its remaining bytes arrive — or forever, which recovery-time
        torn-tail dropping handles."""
        self._open_new()
        out = []
        dead = []
        for entry in self._streams:
            ino, fh, unpacker = entry
            try:
                data = fh.read()
            except OSError:
                data = b""
            if data:
                unpacker.feed(data)
                while True:
                    try:
                        rec = next(unpacker)
                    except StopIteration:
                        break
                    except Exception:  # noqa: BLE001 — corrupt bytes: stop
                        dead.append(entry)
                        break
                    if _valid_record(rec):
                        out.append(rec)
            elif os.fstat(fh.fileno()).st_nlink == 0:
                # unlinked by compaction and fully drained: retire
                dead.append(entry)
        for entry in dead:
            self._streams.remove(entry)
            entry[1].close()
            # forget the retired inode number: the filesystem can reuse it
            # for a future wal.msgpack, which _open_new must then OPEN, not
            # skip (a skipped reused inode would silently end the tail)
            self._known_inodes.discard(entry[0])
        out.sort(key=lambda r: r.get(REC_SEQ_KEY, 0))
        return out

    def close(self) -> None:
        for _, fh, _ in self._streams:
            fh.close()
        self._streams.clear()


# ---------------------------------------------------------------------------
# sqlite backend (the rocksdb-style embedded alternative)
# ---------------------------------------------------------------------------


_SQLITE_SCHEMA = """
CREATE TABLE IF NOT EXISTS wal (seq INTEGER PRIMARY KEY, rec BLOB NOT NULL);
CREATE TABLE IF NOT EXISTS snap (
    id INTEGER PRIMARY KEY CHECK (id = 0),
    state BLOB NOT NULL, wal_seq INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS meta (key TEXT PRIMARY KEY, value INTEGER);
"""


class SqliteBackend:
    """One sqlite file; WAL-journal mode so the standby's read connection
    tails while the leader writes. Fencing is transactional: the epoch
    lives in the `meta` table and every append is an INSERT guarded by
    `epoch <= mine` — a zombie's mutation fails atomically, with no
    window."""

    name = "sqlite"

    def __init__(self, directory: str, epoch: int = 0):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, SQLITE_DB)
        self.epoch = epoch
        self._db = sqlite3.connect(self.path, timeout=10.0)
        self._db.executescript(_SQLITE_SCHEMA)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(
            "INSERT OR IGNORE INTO meta(key, value) VALUES ('epoch', 0)")
        if epoch:
            cur = self._db.execute(
                "UPDATE meta SET value = ? WHERE key = 'epoch' AND value < ?",
                (epoch, epoch))
            if cur.rowcount == 0:
                row = self._db.execute(
                    "SELECT value FROM meta WHERE key = 'epoch'").fetchone()
                if row and row[0] > epoch:
                    self._db.commit()
                    self._db.close()
                    raise FencedError(
                        f"sqlite store already fenced at epoch {row[0]} "
                        f"> {epoch}")
            _write_epoch(directory, max(epoch, read_epoch(directory)))
        self._db.commit()
        self._frozen_seq = 0

    def recover(self) -> tuple:
        snap = None
        row = self._db.execute(
            "SELECT state FROM snap WHERE id = 0").fetchone()
        if row is not None:
            try:
                snap = msgpack.unpackb(row[0], raw=False,
                                       strict_map_key=False)
            except Exception:  # noqa: BLE001 — corrupt snapshot row
                logger.exception("sqlite snapshot unreadable; WAL only")
        records = []
        for (blob,) in self._db.execute(
                "SELECT rec FROM wal ORDER BY seq"):
            try:
                rec = msgpack.unpackb(blob, raw=False, strict_map_key=False)
            except Exception:  # noqa: BLE001 — corrupt row: stop at it
                logger.warning("dropping corrupt sqlite WAL record")
                break
            if not _valid_record(rec):
                logger.warning("dropping malformed sqlite WAL record")
                break
            records.append(rec)
        return snap, records

    def append(self, record: dict) -> None:
        seq = record.get(REC_SEQ_KEY, 0)
        cur = self._db.execute(
            "INSERT INTO wal(seq, rec) SELECT ?, ? WHERE "
            "(SELECT value FROM meta WHERE key = 'epoch') <= ?",
            (seq, msgpack.packb(record), self.epoch or 0))
        if cur.rowcount == 0:
            self._db.rollback()
            raise FencedError(
                f"epoch {self.epoch} superseded; append refused")
        self._db.commit()

    def rotate(self) -> None:
        row = self._db.execute("SELECT MAX(seq) FROM wal").fetchone()
        self._frozen_seq = row[0] or 0

    def write_snapshot(self, state: dict) -> None:
        frozen = self._frozen_seq
        # a FRESH connection per snapshot: this runs on a worker thread
        # during live compaction (sqlite3 connections are bound to their
        # creating thread), and compactions are rare enough that the
        # connect cost is noise
        db = sqlite3.connect(self.path, timeout=10.0)
        try:
            with db:  # one transaction: fold + trim atomically
                cur = db.execute(
                    "SELECT value FROM meta WHERE key = 'epoch'").fetchone()
                if self.epoch and cur and cur[0] > self.epoch:
                    raise FencedError(
                        f"epoch {self.epoch} superseded; refusing snapshot")
                db.execute(
                    "INSERT OR REPLACE INTO snap(id, state, wal_seq) "
                    "VALUES (0, ?, ?)",
                    (msgpack.packb(state), state.get(SNAP_SEQ_KEY, frozen)))
                db.execute("DELETE FROM wal WHERE seq <= ?", (frozen,))
        except sqlite3.Error as e:
            raise RuntimeError(f"sqlite snapshot failed: {e}") from e
        finally:
            db.close()

    def close(self) -> None:
        try:
            self._db.commit()
            self._db.close()
        except sqlite3.Error:
            pass


class SqliteTailer:
    """Warm-standby tail of a SqliteBackend: records with seq > cursor.
    Compaction can delete rows the standby never saw (it fell behind a
    whole compaction window); the seq gap is detected by the WalStore-level
    tail driver, which re-seeds from the snapshot."""

    def __init__(self, directory: str):
        self.dir = directory
        self.path = os.path.join(directory, SQLITE_DB)
        self._db: Optional[sqlite3.Connection] = None
        self._cursor = 0

    def _conn(self) -> Optional[sqlite3.Connection]:
        if self._db is None:
            if not os.path.exists(self.path):
                return None
            self._db = sqlite3.connect(self.path, timeout=10.0)
        return self._db

    def read_snapshot(self) -> Optional[dict]:
        db = self._conn()
        if db is None:
            return None
        try:
            row = db.execute("SELECT state FROM snap WHERE id = 0").fetchone()
        except sqlite3.Error:
            return None
        if row is None:
            return None
        try:
            return msgpack.unpackb(row[0], raw=False, strict_map_key=False)
        except Exception:  # noqa: BLE001
            return None

    def poll(self) -> list:
        db = self._conn()
        if db is None:
            return []
        out = []
        try:
            rows = db.execute(
                "SELECT seq, rec FROM wal WHERE seq > ? ORDER BY seq",
                (self._cursor,)).fetchall()
        except sqlite3.Error:
            return []
        for seq, blob in rows:
            try:
                rec = msgpack.unpackb(blob, raw=False, strict_map_key=False)
            except Exception:  # noqa: BLE001
                break
            if not _valid_record(rec):
                break
            self._cursor = max(self._cursor, seq)
            out.append(rec)
        return out

    def close(self) -> None:
        if self._db is not None:
            self._db.close()
            self._db = None


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


_BACKENDS = {"file": FileBackend, "sqlite": SqliteBackend}
_TAILERS = {"file": FileTailer, "sqlite": SqliteTailer}


def _backend_name(backend: Optional[str]) -> str:
    if backend is None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        backend = GLOBAL_CONFIG.get("control_store_backend")
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown control_store_backend {backend!r} "
            f"(choices: {sorted(_BACKENDS)})")
    return backend


class WalStore:
    """Append-only log with snapshot compaction over a pluggable backend.

    Compaction is two-phase so the (potentially large) state pack + fsync can
    run on a worker thread without losing concurrent appends: `rotate()` (on
    the event loop, cheap) freezes the current log; `write_snapshot(state)`
    (threadable) atomically replaces the snapshot — which already reflects
    the frozen log — and drops the folded records. Recovery replays
    snapshot → frozen log → live log.

    Every record is stamped with a monotonic seq (`i`, resumed across
    restarts) and the snapshot carries `_wal_seq` — see the module
    docstring for why."""

    def __init__(self, directory: str, compact_every: int = 512,
                 backend: Optional[str] = None, epoch: int = 0):
        self.dir = directory
        self.compact_every = compact_every
        self.epoch = epoch
        self.backend = _BACKENDS[_backend_name(backend)](directory, epoch)
        self._appends_since_compact = 0
        self._seq = 0
        self._frozen_seq = 0

    # -- recovery -------------------------------------------------------

    def recover(self) -> tuple:
        """Return (snapshot_state_or_None, wal_records). A torn/corrupt
        final WAL record (crash mid-write) is dropped; the append seq
        resumes after the highest recovered stamp."""
        snap, records = self.backend.recover()
        if snap is not None:
            self._seq = max(self._seq, int(snap.pop(SNAP_SEQ_KEY, 0) or 0))
        for rec in records:
            self._seq = max(self._seq, int(rec.get(REC_SEQ_KEY, 0) or 0))
        return snap, records

    def adopt_seq(self, seq: int) -> None:
        """Resume the append counter after `seq` (warm-standby takeover:
        the tailer, not recover(), saw the existing records)."""
        self._seq = max(self._seq, int(seq))

    @property
    def seq(self) -> int:
        return self._seq

    # -- writes ---------------------------------------------------------

    def append(self, record: dict) -> bool:
        """Append one record; True when a compaction is due (caller copies
        state, calls rotate(), then write_snapshot() — possibly on a
        thread). Raises FencedError if a newer leader owns the store."""
        self._seq += 1
        record[REC_SEQ_KEY] = self._seq
        self.backend.append(record)
        self._appends_since_compact += 1
        return self._appends_since_compact >= self.compact_every

    def rotate(self) -> None:
        self._frozen_seq = self._seq
        self.backend.rotate()
        self._appends_since_compact = 0

    def write_snapshot(self, state: dict) -> None:
        state = {**state, SNAP_SEQ_KEY: self._frozen_seq}
        self.backend.write_snapshot(state)

    def snapshot(self, state: dict) -> None:
        """Synchronous rotate + write (small states / takeover fold)."""
        self.rotate()
        self.write_snapshot(state)

    def close(self) -> None:
        self.backend.close()


class WalTail:
    """The warm-standby driver over a backend tailer: dedups compaction-
    rotation duplicates by seq, detects seq gaps (records folded away
    before we saw them) and re-seeds from the snapshot.

    poll() returns a list of ("snapshot", state) / ("record", rec) items to
    apply IN ORDER: a snapshot item means reset tables and re-seed."""

    def __init__(self, directory: str, backend: Optional[str] = None):
        self.dir = directory
        self.tailer = _TAILERS[_backend_name(backend)](directory)
        self.last_seq = 0
        self._seeded = False
        # records held back because a seq gap wasn't covered by a snapshot
        # re-seed yet (transient snapshot-read failure / replace race):
        # consuming them would silently lose the missed window forever
        self._held: list = []

    @property
    def drained(self) -> bool:
        """True when nothing is held back waiting on a snapshot re-seed."""
        return not self._held

    def _seed(self) -> list:
        state = self.tailer.read_snapshot()
        if state is None:
            return []
        self.last_seq = max(self.last_seq,
                            int(state.pop(SNAP_SEQ_KEY, 0) or 0))
        return [("snapshot", state)]

    def poll(self) -> list:
        out = []
        if not self._seeded:
            # seed AFTER the tailer opened its handles: records folded by a
            # compaction racing us are covered by the snapshot's _wal_seq
            out.extend(self._seed())
            self._seeded = True
        records = self._held + self.tailer.poll()
        self._held = []
        for idx, rec in enumerate(records):
            seq = int(rec.get(REC_SEQ_KEY, 0) or 0)
            if seq and seq <= self.last_seq:
                continue  # rotation-merge duplicate
            if seq > self.last_seq + 1:
                # gap: a compaction folded records we never saw (sqlite
                # trim, or a whole rotate+fold between polls) — the
                # snapshot is the only copy now
                reseed = self._seed()
                if reseed:
                    out.extend(reseed)
                if seq and seq <= self.last_seq:
                    continue  # snapshot covered this record too
                if seq > self.last_seq + 1:
                    # the re-seed did NOT cover the gap (snapshot read
                    # transiently failed, or an old snapshot is still
                    # installed): hold everything from here and retry next
                    # poll — advancing past the gap would lose the missed
                    # records permanently. The compaction that created the
                    # gap commits its covering snapshot atomically, so a
                    # later seed must cover it.
                    self._held = records[idx:]
                    break
            self.last_seq = seq or self.last_seq
            out.append(("record", rec))
        return out

    def close(self) -> None:
        self.tailer.close()


def open_tailer(directory: str, backend: Optional[str] = None) -> WalTail:
    return WalTail(directory, backend)
