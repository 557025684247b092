"""Log-structured KV store with a crc-protected WAL (reference role:
src/kv/RocksDBStore.{h,cc} over BlueFS — the metadata/commit engine under
BlueStore and the MonitorDBStore; SURVEY.md §2.4, §5.4).

Design: an append-only WAL of batches.  Each batch is
    [u32 len][u32 crc32c(payload)][payload]
where payload encodes the (set/rm) ops.  A batch is durable once the record
is written (+fsync when sync=True); recovery replays the WAL in order and
stops at the first torn/corrupt record — exactly the RocksDB WAL contract
that gives the reference its all-or-nothing transaction semantics.
`compact()` writes a snapshot of the live map and truncates the WAL
(RocksDB's memtable flush analog, radically simplified).
"""
from __future__ import annotations

import os
import struct

from ..common.buffer import BufferList, BufferListIterator
from ..common.lockdep import make_lock
from ..common.crc32c import crc32c

_OP_SET = 1
_OP_RM = 2

_SNAP_MAGIC = b"ctpu-kv-snap-v1\n"


class KeyValueDB:
    """Transactional KV contract (reference: src/kv/KeyValueDB.h)."""

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def set(self, key: str, value: bytes, sync: bool = False) -> None:
        self.submit_batch([(_OP_SET, key, bytes(value))], sync=sync)

    def rm(self, key: str, sync: bool = False) -> None:
        self.submit_batch([(_OP_RM, key, b"")], sync=sync)

    def submit_batch(self, ops, sync: bool = False) -> None:
        """ops: list of (op, key, value); atomic."""
        raise NotImplementedError

    def iterate(self, prefix: str = ""):
        raise NotImplementedError


class MemKV(KeyValueDB):
    """In-RAM KV for disk-less daemons in tests (MemStore's analog at the
    KV layer)."""

    def __init__(self):
        self._map: dict[str, bytes] = {}
        self._lock = make_lock("store::kv")

    def submit_batch(self, ops, sync: bool = False) -> None:
        if isinstance(ops, Batch):
            ops = ops.ops
        with self._lock:
            for op, key, value in ops:
                if op == _OP_SET:
                    self._map[key] = bytes(value)
                else:
                    self._map.pop(key, None)

    def get(self, key: str) -> bytes | None:
        with self._lock:
            return self._map.get(key)

    def iterate(self, prefix: str = ""):
        with self._lock:
            keys = sorted(k for k in self._map if k.startswith(prefix))
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def close(self) -> None:
        pass


class Batch:
    """Write batch builder (reference: KeyValueDB::Transaction)."""

    def __init__(self):
        self.ops: list[tuple[int, str, bytes]] = []

    def set(self, key: str, value: bytes) -> "Batch":
        self.ops.append((_OP_SET, key, bytes(value)))
        return self

    def rm(self, key: str) -> "Batch":
        self.ops.append((_OP_RM, key, b""))
        return self


class LogKV(KeyValueDB):
    """WAL + snapshot file pair in a directory."""

    def __init__(self, path: str, sync_default: bool = True,
                 compact_threshold: int = 64 << 20,
                 readonly: bool = False):
        """readonly: pure inspection open (kvstore-tool role) — never
        creates the directory, never truncates a torn WAL tail (the torn
        record is evidence on a corrupt store), never opens the WAL for
        append; submit_batch refuses."""
        self.path = path
        self.sync_default = sync_default
        self.compact_threshold = compact_threshold
        self.readonly = readonly
        self._map: dict[str, bytes] = {}
        self._lock = make_lock("store::kv")
        self._wal = None
        if not readonly:
            os.makedirs(path, exist_ok=True)
        self._snap_path = os.path.join(path, "snapshot")
        self._wal_path = os.path.join(path, "wal")
        self._recover()

    # -- recovery ---------------------------------------------------------
    def _recover(self) -> None:
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                raw = f.read()
            if not raw.startswith(_SNAP_MAGIC):
                raise IOError(f"{self._snap_path}: bad snapshot magic")
            body = raw[len(_SNAP_MAGIC):]
            (crc,) = struct.unpack("<I", body[:4])
            payload = body[4:]
            if crc32c(payload) != crc:
                raise IOError(f"{self._snap_path}: snapshot crc mismatch")
            it = BufferListIterator(payload)
            for _ in range(it.get_u32()):
                k = it.get_str()
                self._map[k] = it.get_str_bytes()
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                wal = f.read()
            pos = 0
            while pos + 8 <= len(wal):
                length, crc = struct.unpack_from("<II", wal, pos)
                payload = wal[pos + 8 : pos + 8 + length]
                if len(payload) < length or crc32c(payload) != crc:
                    break  # torn tail: last batch never committed
                self._replay(payload)
                pos += 8 + length
            if pos < len(wal) and not self.readonly:
                # drop the torn tail so future appends start at a clean
                # record boundary (RocksDB recycles the WAL the same way)
                with open(self._wal_path, "r+b") as f:
                    f.truncate(pos)
        if not self.readonly:
            self._wal = open(self._wal_path, "ab")

    def _replay(self, payload: bytes) -> None:
        it = BufferListIterator(payload)
        for _ in range(it.get_u32()):
            op = it.get_u8()
            key = it.get_str()
            val = it.get_str_bytes()
            if op == _OP_SET:
                self._map[key] = val
            else:
                self._map.pop(key, None)

    # -- writes -----------------------------------------------------------
    def submit_batch(self, ops, sync: bool | None = None) -> None:
        if self.readonly:
            raise IOError("read-only KV open refuses writes")
        if isinstance(ops, Batch):
            ops = ops.ops
        sync = self.sync_default if sync is None else sync
        bl = BufferList()
        bl.append_u32(len(ops))
        for op, key, value in ops:
            bl.append_u8(op)
            bl.append_str(key)
            bl.append_str(value)
        payload = bytes(bl)
        record = struct.pack("<II", len(payload), crc32c(payload)) + payload
        with self._lock:
            self._wal.write(record)
            self._wal.flush()
            if sync:
                os.fsync(self._wal.fileno())
            self._replay(payload)
            if self._wal.tell() >= self.compact_threshold:
                self._compact_locked()

    # -- reads ------------------------------------------------------------
    def get(self, key: str) -> bytes | None:
        with self._lock:
            return self._map.get(key)

    def iterate(self, prefix: str = ""):
        with self._lock:
            keys = sorted(k for k in self._map if k.startswith(prefix))
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    # -- maintenance ------------------------------------------------------
    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        bl = BufferList()
        bl.append_u32(len(self._map))
        for k in sorted(self._map):
            bl.append_str(k)
            bl.append_str(self._map[k])
        payload = bytes(bl)
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_SNAP_MAGIC + struct.pack("<I", crc32c(payload)) + payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        self._wal.close()
        self._wal = open(self._wal_path, "wb")  # truncate

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None
