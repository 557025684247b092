"""MemStore — in-RAM ObjectStore (reference: src/os/memstore/MemStore.{h,cc};
SURVEY.md §4 ring 3: the unit-test backend so OSD-level tests need no disk).
"""
from __future__ import annotations

from ..common.lockdep import make_lock
from typing import Callable

from .object_store import Collection, NotFound, ObjectStore, Transaction


class MemStore(ObjectStore):
    def __init__(self):
        self._colls: dict[str, Collection] = {}
        self._lock = make_lock("store::memstore")

    def queue_transaction(
        self, t: Transaction, on_commit: Callable[[], None] | None = None
    ) -> None:
        # torn-write injection (docs/fault_injection.md): an error BEFORE
        # the apply fails the txn with nothing durable; one AFTER fails
        # the caller although the txn committed — the crash-between-ack-
        # and-apply shapes recovery must absorb
        self._fp_hit("osd.store.write_before_commit")
        with self._lock:
            self.apply_atomic(self._colls, t)
        self._fp_hit("osd.store.write_after_commit")
        if on_commit:
            on_commit()

    def _object(self, cid: str, oid: str):
        c = self._colls.get(cid)
        if c is None:
            raise NotFound(f"collection {cid}")
        o = c.objects.get(oid)
        if o is None:
            raise NotFound(f"object {cid}/{oid}")
        return o

    def read(self, cid: str, oid: str, off: int = 0, length: int = -1) -> bytes:
        with self._lock:
            o = self._object(cid, oid)
            if length < 0:
                return bytes(o.data[off:])
            return bytes(o.data[off : off + length])

    def stat(self, cid: str, oid: str) -> dict:
        with self._lock:
            o = self._object(cid, oid)
            return {"size": len(o.data)}

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        with self._lock:
            o = self._object(cid, oid)
            if name not in o.xattrs:
                raise NotFound(f"xattr {name} on {cid}/{oid}")
            return o.xattrs[name]

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            return dict(self._object(cid, oid).xattrs)

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            return dict(self._object(cid, oid).omap)

    def list_collections(self) -> list[str]:
        with self._lock:
            return sorted(self._colls)

    def list_objects(self, cid: str) -> list[str]:
        with self._lock:
            c = self._colls.get(cid)
            if c is None:
                raise NotFound(f"collection {cid}")
            return sorted(c.objects)
