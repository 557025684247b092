"""KStore — crash-safe file-backed ObjectStore over LogKV (reference role:
src/os/bluestore/BlueStore.{h,cc}'s commit path: every Transaction becomes
one atomic KV WAL batch, fsync'd before the commit callback fires, replayed
on mount; SURVEY.md §2.4, §5.4 "BlueStore transactions: all-or-nothing
commit via RocksDB WAL").

State model: the live {cid: Collection} image is in RAM (objects here are
metadata+data values, not a block device); the KV holds the authoritative
absolute state — per-object data/xattr/omap keys — so WAL replay is
idempotent.  A Transaction is applied to the RAM image first (validating,
all-or-nothing), then persisted as one batch of absolute post-state values.
"""
from __future__ import annotations

from ..common.lockdep import make_lock
from typing import Callable

from .kv import Batch, LogKV
from .memstore import MemStore
from .object_store import Collection, NotFound, Object, Transaction

_SEP = "\x00"


def _dkey(cid: str, oid: str) -> str:
    return f"D{_SEP}{cid}{_SEP}{oid}"


def _akey(cid: str, oid: str, name: str) -> str:
    return f"A{_SEP}{cid}{_SEP}{oid}{_SEP}{name}"


def _okey(cid: str, oid: str, key: str) -> str:
    return f"O{_SEP}{cid}{_SEP}{oid}{_SEP}{key}"


def _ckey(cid: str) -> str:
    return f"C{_SEP}{cid}"


def _zkey(cid: str, oid: str) -> str:
    """Compressed-data twin of _dkey (value: b"<algo>\\x00" + blob)."""
    return f"Z{_SEP}{cid}{_SEP}{oid}"


class KStore(MemStore):
    """MemStore's read paths + apply loop, with a durable KV underneath."""

    def __init__(self, path: str, sync: bool = True,
                 compression: str = "none"):
        super().__init__()
        self.path = path
        self._kv = LogKV(path, sync_default=sync)
        self._mounted = False
        self._io_lock = make_lock("store::kstore_io")
        # at-rest object-data compression (reference: bluestore_compression
        # — data only, stored iff it actually shrinks; xattr/omap stay raw)
        self._compressor = None
        if compression and compression != "none":
            from ..compressor import Compressor

            self._compressor = Compressor.create(compression)

    # -- lifecycle --------------------------------------------------------
    def mount(self) -> None:
        """Rebuild the RAM image from the KV (replays the WAL internally)."""
        with self._io_lock:
            colls: dict[str, Collection] = {}
            for key, _ in self._kv.iterate(f"C{_SEP}"):
                colls[key.split(_SEP, 1)[1]] = Collection()
            for key, val in self._kv.iterate(f"D{_SEP}"):
                _, cid, oid = key.split(_SEP, 2)
                colls[cid].objects[oid] = Object(data=bytearray(val))
            decompressors: dict[str, object] = {}
            for key, val in self._kv.iterate(f"Z{_SEP}"):
                _, cid, oid = key.split(_SEP, 2)
                algo, _, blob = bytes(val).partition(b"\x00")
                name = algo.decode()
                comp = decompressors.get(name)
                if comp is None:
                    from ..compressor import Compressor

                    comp = decompressors[name] = Compressor.create(name)
                colls[cid].objects[oid] = Object(
                    data=bytearray(comp.decompress(blob))
                )
            for key, val in self._kv.iterate(f"A{_SEP}"):
                _, cid, oid, name = key.split(_SEP, 3)
                colls[cid].objects[oid].xattrs[name] = val
            for key, val in self._kv.iterate(f"O{_SEP}"):
                _, cid, oid, okey = key.split(_SEP, 3)
                colls[cid].objects[oid].omap[okey] = val
            self._colls = colls
            self._mounted = True

    def umount(self) -> None:
        with self._io_lock:
            self._kv.close()
            self._mounted = False

    def compact(self) -> None:
        self._kv.compact()

    # -- writes -----------------------------------------------------------
    def queue_transaction(
        self, t: Transaction, on_commit: Callable[[], None] | None = None
    ) -> None:
        # torn-write injection: before = nothing durable, after = the WAL
        # batch committed but the caller sees a failure (the crash shapes
        # WAL replay and dup detection must absorb)
        self._fp_hit("osd.store.write_before_commit")
        with self._io_lock, self._lock:
            before_colls = set(self._colls)
            touched = {(op.cid, op.oid) for op in t.ops if op.oid} | {
                (op.dest_cid, op.dest_oid) for op in t.ops if op.dest_oid
            }
            # stale xattr/omap key names come from the pre-apply RAM image
            # (no KV scans — LogKV.iterate sorts the whole keyspace)
            stale: dict[tuple[str, str], tuple[set[str], set[str]]] = {}
            for cid, oid in touched:
                c = self._colls.get(cid)
                o = c.objects.get(oid) if c else None
                stale[(cid, oid)] = (
                    (set(o.xattrs), set(o.omap)) if o else (set(), set())
                )
            self.apply_atomic(self._colls, t)
            batch = Batch()
            for cid in before_colls - set(self._colls):
                batch.rm(_ckey(cid))
            for cid in set(self._colls) - before_colls:
                batch.set(_ckey(cid), b"")
            for cid, oid in sorted(touched):
                # clear any stale keys for the object, then write absolute
                # post-state — makes the batch idempotent under replay
                batch.rm(_dkey(cid, oid))
                batch.rm(_zkey(cid, oid))
                old_xattrs, old_omap = stale[(cid, oid)]
                for name in old_xattrs:
                    batch.rm(_akey(cid, oid, name))
                for key in old_omap:
                    batch.rm(_okey(cid, oid, key))
                c = self._colls.get(cid)
                o = c.objects.get(oid) if c else None
                if o is not None:
                    raw = bytes(o.data)
                    blob = None
                    if self._compressor is not None and raw:
                        z = self._compressor.compress(raw)
                        if len(z) < len(raw):  # store compressed iff it wins
                            blob = (
                                self._compressor.NAME.encode() + b"\x00" + z
                            )
                    if blob is not None:
                        batch.set(_zkey(cid, oid), blob)
                    else:
                        batch.set(_dkey(cid, oid), raw)
                    for name, val in o.xattrs.items():
                        batch.set(_akey(cid, oid, name), val)
                    for key, val in o.omap.items():
                        batch.set(_okey(cid, oid, key), val)
            self._kv.submit_batch(batch)
        self._fp_hit("osd.store.write_after_commit")
        if on_commit:
            on_commit()

    # -- fsck (reference: BlueStore::fsck — mount-time consistency) -------
    def fsck(self) -> list[str]:
        errors = []
        with self._io_lock:
            seen_colls = {
                key.split(_SEP, 1)[1] for key, _ in self._kv.iterate(f"C{_SEP}")
            }
            for kind in ("D", "Z"):
                for key, _ in self._kv.iterate(f"{kind}{_SEP}"):
                    _, cid, _oid = key.split(_SEP, 2)
                    if cid not in seen_colls:
                        errors.append(
                            f"object key {key!r} in missing collection"
                        )
            for kind in ("A", "O"):
                for key, _ in self._kv.iterate(f"{kind}{_SEP}"):
                    _, cid, oid, _rest = key.split(_SEP, 3)
                    if (
                        self._kv.get(_dkey(cid, oid)) is None
                        and self._kv.get(_zkey(cid, oid)) is None
                    ):
                        errors.append(f"{key!r} has no object data key")
        return errors


class FileStore(KStore):
    """Alias retained for the `objectstore = filestore` config spelling."""
