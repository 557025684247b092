"""ObjectStore interface + Transaction (reference: src/os/ObjectStore.h ::
ObjectStore, Transaction; SURVEY.md §2.4).

A Transaction is a serialized list of ops applied all-or-nothing by
`queue_transaction` — the OSD's PGBackend builds one per client write
(reference: §3.1 "BlueStore txc commit").  Objects live in collections
(= PGs); object identity is (collection, oid).  The op set covers what the
data plane uses: object data (write/zero/truncate/remove), xattrs, omap,
collection lifecycle, and rename for recovery temp objects.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable

from ..common.buffer import BufferList, BufferListIterator
from ..common.failpoint import failpoint as _failpoint, registry as _fp_registry


class StoreError(RuntimeError):
    pass


class NotFound(StoreError, KeyError):
    pass


# Transaction op codes (reference: Transaction::OP_*)
OP_TOUCH = 1
OP_WRITE = 2
OP_ZERO = 3
OP_TRUNCATE = 4
OP_REMOVE = 5
OP_SETATTR = 6
OP_RMATTR = 7
OP_OMAP_SETKEYS = 8
OP_OMAP_RMKEYS = 9
OP_OMAP_CLEAR = 10
OP_MKCOLL = 11
OP_RMCOLL = 12
OP_COLL_MOVE_RENAME = 13
OP_TRY_MKCOLL = 14  # idempotent create (collection may already exist)


@dataclass
class Op:
    op: int
    cid: str = ""
    oid: str = ""
    off: int = 0
    length: int = 0
    data: bytes = b""
    name: str = ""
    keys: dict[str, bytes] = field(default_factory=dict)
    dest_cid: str = ""
    dest_oid: str = ""


class Transaction:
    """Ordered op list with all-or-nothing apply semantics."""

    def __init__(self):
        self.ops: list[Op] = []

    def __len__(self) -> int:
        return len(self.ops)

    # -- object data ------------------------------------------------------
    def touch(self, cid: str, oid: str) -> "Transaction":
        self.ops.append(Op(OP_TOUCH, cid, oid))
        return self

    def write(self, cid: str, oid: str, off: int, data) -> "Transaction":
        self.ops.append(Op(OP_WRITE, cid, oid, off=off, data=bytes(BufferList(data))))
        return self

    def zero(self, cid: str, oid: str, off: int, length: int) -> "Transaction":
        self.ops.append(Op(OP_ZERO, cid, oid, off=off, length=length))
        return self

    def truncate(self, cid: str, oid: str, size: int) -> "Transaction":
        self.ops.append(Op(OP_TRUNCATE, cid, oid, off=size))
        return self

    def remove(self, cid: str, oid: str) -> "Transaction":
        self.ops.append(Op(OP_REMOVE, cid, oid))
        return self

    # -- xattrs -----------------------------------------------------------
    def setattr(self, cid: str, oid: str, name: str, value) -> "Transaction":
        self.ops.append(
            Op(OP_SETATTR, cid, oid, name=name, data=bytes(BufferList(value)))
        )
        return self

    def rmattr(self, cid: str, oid: str, name: str) -> "Transaction":
        self.ops.append(Op(OP_RMATTR, cid, oid, name=name))
        return self

    # -- omap -------------------------------------------------------------
    def omap_setkeys(self, cid: str, oid: str, keys: dict[str, bytes]) -> "Transaction":
        self.ops.append(Op(OP_OMAP_SETKEYS, cid, oid, keys=dict(keys)))
        return self

    def omap_rmkeys(self, cid: str, oid: str, keys: Iterable[str]) -> "Transaction":
        self.ops.append(
            Op(OP_OMAP_RMKEYS, cid, oid, keys={k: b"" for k in keys})
        )
        return self

    def omap_clear(self, cid: str, oid: str) -> "Transaction":
        self.ops.append(Op(OP_OMAP_CLEAR, cid, oid))
        return self

    # -- collections ------------------------------------------------------
    def create_collection(self, cid: str) -> "Transaction":
        self.ops.append(Op(OP_MKCOLL, cid))
        return self

    def try_create_collection(self, cid: str) -> "Transaction":
        """Create-if-missing (the OSD touches its shard collection on every
        write; reference: OSD collections are created at PG instantiation,
        but this daemon creates them lazily)."""
        self.ops.append(Op(OP_TRY_MKCOLL, cid))
        return self

    def remove_collection(self, cid: str) -> "Transaction":
        self.ops.append(Op(OP_RMCOLL, cid))
        return self

    def collection_move_rename(
        self, cid: str, oid: str, dest_cid: str, dest_oid: str
    ) -> "Transaction":
        self.ops.append(
            Op(OP_COLL_MOVE_RENAME, cid, oid, dest_cid=dest_cid, dest_oid=dest_oid)
        )
        return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    # -- wire/WAL encoding (used by KStore's log and the OSD's repops) ----
    def encode(self) -> BufferList:
        bl = BufferList()
        bl.append_u32(len(self.ops))
        for op in self.ops:
            bl.append_u8(op.op)
            bl.append_str(op.cid)
            bl.append_str(op.oid)
            bl.append_u64(op.off)
            bl.append_u64(op.length)
            bl.append_str(op.data)
            bl.append_str(op.name)
            bl.append_str(op.dest_cid)
            bl.append_str(op.dest_oid)
            bl.append_u32(len(op.keys))
            for k, v in op.keys.items():
                bl.append_str(k)
                bl.append_str(v)
        return bl

    @classmethod
    def decode(cls, it: BufferListIterator | bytes) -> "Transaction":
        if not isinstance(it, BufferListIterator):
            it = BufferListIterator(bytes(it))
        t = cls()
        for _ in range(it.get_u32()):
            op = Op(it.get_u8())
            op.cid = it.get_str()
            op.oid = it.get_str()
            op.off = it.get_u64()
            op.length = it.get_u64()
            op.data = it.get_str_bytes()
            op.name = it.get_str()
            op.dest_cid = it.get_str()
            op.dest_oid = it.get_str()
            op.keys = {}
            for _ in range(it.get_u32()):
                k = it.get_str()
                op.keys[k] = it.get_str_bytes()
            t.ops.append(op)
        return t


@dataclass
class Object:
    data: bytearray = field(default_factory=bytearray)
    xattrs: dict[str, bytes] = field(default_factory=dict)
    omap: dict[str, bytes] = field(default_factory=dict)


@dataclass
class Collection:
    objects: dict[str, Object] = field(default_factory=dict)


class ObjectStore:
    """Backend contract (reference: ObjectStore pure virtuals the OSD uses)."""

    def mount(self) -> None:  # reference: ObjectStore::mount
        pass

    def umount(self) -> None:
        pass

    def _fp_hit(self, name: str) -> None:
        """Evaluate a store-layer failpoint with this store's owner tags
        (fp_entity/fp_cct, stamped by the owning OSD) so per-daemon
        entries match — shared by every backend's commit path.  The
        configured() guard keeps the off-state commit path free (this
        runs twice per transaction on every OSD)."""
        if _fp_registry().configured(name):
            _failpoint(name, cct=getattr(self, "fp_cct", None),
                       entity=getattr(self, "fp_entity", None))

    # -- writes -----------------------------------------------------------
    def queue_transaction(
        self, t: Transaction, on_commit: Callable[[], None] | None = None
    ) -> None:
        raise NotImplementedError

    # -- reads ------------------------------------------------------------
    def read(self, cid: str, oid: str, off: int = 0, length: int = -1) -> bytes:
        raise NotImplementedError

    def stat(self, cid: str, oid: str) -> dict:
        raise NotImplementedError

    def exists(self, cid: str, oid: str) -> bool:
        try:
            self.stat(cid, oid)
            return True
        except NotFound:
            return False

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        raise NotImplementedError

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def list_collections(self) -> list[str]:
        raise NotImplementedError

    def collection_exists(self, cid: str) -> bool:
        return cid in self.list_collections()

    def list_objects(self, cid: str) -> list[str]:
        raise NotImplementedError

    def collection_bytes(self, cid: str) -> int:
        """Total logical object bytes in a collection (stats-report path —
        backends override with their O(metadata) walk; this default pays a
        stat per object)."""
        return sum(
            self.stat(cid, o)["size"] for o in self.list_objects(cid)
            if not o.startswith("_")
        )

    def collections_bytes(self) -> dict[str, int]:
        """{cid: bytes} for every collection in ONE metadata pass — the
        per-report-tick stats surface (a per-collection loop over a
        store-wide index would be O(collections x objects))."""
        return {
            cid: self.collection_bytes(cid)
            for cid in self.list_collections()
        }

    def statfs(self) -> dict:
        """{total, used, avail} device bytes (reference:
        ObjectStore::statfs — feeds `ceph df` / `ceph osd df`).
        Backends without a real device report a nominal 1 GiB device
        with logical usage."""
        used = sum(self.collections_bytes().values())
        total = max(1 << 30, used)  # invariant: used <= total
        return {"total": total, "used": used,
                "avail": total - used}

    # -- shared Transaction interpreter ------------------------------------
    # Backends that materialize state as {cid: Collection} dicts reuse this
    # (MemStore applies directly; KStore applies to its in-RAM image after
    # the WAL commit).
    @staticmethod
    def apply_atomic(colls: dict[str, Collection], t: Transaction) -> None:
        """All-or-nothing apply (the Transaction contract, reference:
        ObjectStore.h 'transactions are atomic').  Rollback state is
        O(touched objects), not O(collection): only the objects the
        transaction names are snapshotted; collection-level ops save the
        Collection reference (MKCOLL/RMCOLL only ever add/remove an empty
        one, so the reference plus the touched-object snapshots restore
        everything)."""
        import copy

        saved_objs: dict[tuple[str, str], Object | None] = {}
        for op in t.ops:
            for cid, oid in ((op.cid, op.oid), (op.dest_cid, op.dest_oid)):
                if oid and (cid, oid) not in saved_objs:
                    c = colls.get(cid)
                    o = c.objects.get(oid) if c else None
                    saved_objs[(cid, oid)] = copy.deepcopy(o)
        coll_cids = {op.cid for op in t.ops if not op.oid}
        saved_colls = {cid: colls.get(cid) for cid in coll_cids}
        try:
            ObjectStore._apply(colls, t)
        except Exception:
            for cid, c in saved_colls.items():
                if c is None:
                    colls.pop(cid, None)
                else:
                    colls[cid] = c
            for (cid, oid), o in saved_objs.items():
                c = colls.get(cid)
                if c is None:
                    continue
                if o is None:
                    c.objects.pop(oid, None)
                else:
                    c.objects[oid] = o
            raise

    @staticmethod
    def _apply(colls: dict[str, Collection], t: Transaction) -> None:
        for op in t.ops:
            if op.op == OP_MKCOLL:
                if op.cid in colls:
                    raise StoreError(f"collection {op.cid} exists")
                colls[op.cid] = Collection()
                continue
            if op.op == OP_TRY_MKCOLL:
                colls.setdefault(op.cid, Collection())
                continue
            if op.op == OP_RMCOLL:
                c = colls.get(op.cid)
                if c is None:
                    raise NotFound(f"collection {op.cid}")
                if c.objects:
                    raise StoreError(f"collection {op.cid} not empty")
                del colls[op.cid]
                continue
            c = colls.get(op.cid)
            if c is None:
                raise NotFound(f"collection {op.cid}")
            if op.op == OP_TOUCH:
                c.objects.setdefault(op.oid, Object())
                continue
            if op.op == OP_WRITE:
                o = c.objects.setdefault(op.oid, Object())
                end = op.off + len(op.data)
                if len(o.data) < end:
                    o.data.extend(b"\0" * (end - len(o.data)))
                o.data[op.off : end] = op.data
                continue
            o = c.objects.get(op.oid)
            if o is None:
                raise NotFound(f"object {op.cid}/{op.oid}")
            if op.op == OP_ZERO:
                end = op.off + op.length
                if len(o.data) < end:
                    o.data.extend(b"\0" * (end - len(o.data)))
                o.data[op.off : end] = b"\0" * op.length
            elif op.op == OP_TRUNCATE:
                size = op.off
                if len(o.data) > size:
                    del o.data[size:]
                else:
                    o.data.extend(b"\0" * (size - len(o.data)))
            elif op.op == OP_REMOVE:
                del c.objects[op.oid]
            elif op.op == OP_SETATTR:
                o.xattrs[op.name] = op.data
            elif op.op == OP_RMATTR:
                o.xattrs.pop(op.name, None)
            elif op.op == OP_OMAP_SETKEYS:
                o.omap.update(op.keys)
            elif op.op == OP_OMAP_RMKEYS:
                for k in op.keys:
                    o.omap.pop(k, None)
            elif op.op == OP_OMAP_CLEAR:
                o.omap.clear()
            elif op.op == OP_COLL_MOVE_RENAME:
                dest = colls.get(op.dest_cid)
                if dest is None:
                    raise NotFound(f"collection {op.dest_cid}")
                dest.objects[op.dest_oid] = o
                del c.objects[op.oid]
            else:
                raise StoreError(f"unknown transaction op {op.op}")


def create_store(
    kind: str,
    path: str | None = None,
    compression: str = "none",
    sync: bool = True,
    checksum: bool = True,
    device_size: int = 1 << 30,
) -> ObjectStore:
    """Factory (reference: ObjectStore::create keyed by `objectstore`;
    `compression`/`sync`/`checksum`/`device_size` are the
    objectstore_compression / objectstore_wal_sync /
    objectstore_checksum / bluestore_block_size options)."""
    from .kstore import KStore
    from .memstore import MemStore

    if kind == "memstore":
        return MemStore()
    if kind in ("kstore", "filestore"):
        if not path:
            raise StoreError(f"{kind} requires a path")
        return KStore(path, sync=sync, compression=compression)
    if kind == "bluestore":
        from .bluestore import BlueStore

        if not path:
            raise StoreError("bluestore requires a path")
        return BlueStore(
            path, device_size=device_size, sync=sync, checksum=checksum,
            compression=compression or "none",
        )
    raise StoreError(f"unknown objectstore {kind!r}")
