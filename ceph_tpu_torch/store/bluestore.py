"""BlueStore-analog ObjectStore: raw block-device file + allocator + KV
metadata (reference: src/os/bluestore/BlueStore.{h,cc} — KernelDevice +
BitmapAllocator + RocksDB onodes; SURVEY.md §2.4).

Structure mirrors the reference's split:

- **Block device**: one flat file carved into `block_size` blocks
  (KernelDevice role).  Object payloads live in allocated extents.
- **Allocator**: next-fit bitmap (native C++ via ctypes, Python
  fallback) — see alloc.py.  The freelist is NOT persisted: it is
  rebuilt on mount by walking the onodes, exactly the invariant
  BlueStore's fsck enforces (allocated == referenced).
- **KV metadata**: onodes (size, inline-or-extents, per-extent crc32c),
  xattrs, omap, collections in the WAL'd LogKV (the RocksDB role).

Commit path (copy-on-write, the crash-safety scheme):
 1. materialize post-state of touched objects in RAM (all-or-nothing);
 2. write changed data to FRESHLY allocated extents + fdatasync the
    device — old extents are untouched;
 3. commit ONE atomic KV batch switching onodes to the new extents;
 4. release the old extents back to the in-RAM allocator.
A crash between 2 and 3 leaks the new extents only until the next mount
rebuild; a crash after 3 leaks nothing.  Data writes of objects below
`inline_threshold` live inside the onode value (BlueStore's small-blob /
deferred-write spirit: tiny writes ride the KV WAL, not the device).

fsck(): extent range/overlap audit + (deep) per-extent crc verify, with
leaked-block accounting — the ceph-bluestore-tool fsck role.
"""
from __future__ import annotations

import base64
import json
import os
from typing import Callable

from ..common.crc32c import crc32c
from ..common.lockdep import make_lock
from .alloc import make_allocator
from .kv import Batch, LogKV
from .object_store import (
    NotFound,
    ObjectStore,
    OP_COLL_MOVE_RENAME,
    OP_MKCOLL,
    OP_OMAP_CLEAR,
    OP_OMAP_RMKEYS,
    OP_OMAP_SETKEYS,
    OP_REMOVE,
    OP_RMATTR,
    OP_RMCOLL,
    OP_SETATTR,
    OP_TOUCH,
    OP_TRY_MKCOLL,
    OP_TRUNCATE,
    OP_WRITE,
    OP_ZERO,
    StoreError,
    Transaction,
)

_SEP = "\x00"


def _nkey(cid: str, oid: str) -> str:
    return f"N{_SEP}{cid}{_SEP}{oid}"


def _akey(cid: str, oid: str, name: str) -> str:
    return f"A{_SEP}{cid}{_SEP}{oid}{_SEP}{name}"


def _okey(cid: str, oid: str, key: str) -> str:
    return f"O{_SEP}{cid}{_SEP}{oid}{_SEP}{key}"


def _ckey(cid: str) -> str:
    return f"C{_SEP}{cid}"


class Onode:
    """Per-object metadata (reference: BlueStore::Onode).  Data is either
    inline bytes or a list of device extents with per-extent crc32c."""

    __slots__ = ("size", "inline", "extents", "crcs", "xattrs", "omap",
                 "comp", "clen")

    def __init__(self):
        self.size = 0
        self.inline: bytes | None = b""
        self.extents: list[tuple[int, int]] = []
        self.crcs: list[int] = []
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}
        # at-rest compression (reference: bluestore_compression blobs):
        # comp = algorithm name when the extents hold a COMPRESSED blob
        # of clen stored bytes decompressing to `size` logical bytes
        self.comp: str | None = None
        self.clen = 0

    def stored_len(self) -> int:
        """Bytes actually on the device (compressed or raw)."""
        return self.clen if self.comp else self.size

    def encode(self) -> bytes:
        d = {
            "size": self.size,
            "inline": (
                base64.b64encode(self.inline).decode()
                if self.inline is not None else None
            ),
            "extents": self.extents,
            "crcs": self.crcs,
        }
        if self.comp:
            d["comp"] = self.comp
            d["clen"] = self.clen
        return json.dumps(d).encode()

    @classmethod
    def decode(cls, raw: bytes) -> "Onode":
        d = json.loads(raw)
        o = cls()
        o.size = d["size"]
        o.inline = (
            base64.b64decode(d["inline"]) if d["inline"] is not None else None
        )
        o.extents = [tuple(e) for e in d["extents"]]
        o.crcs = list(d["crcs"])
        o.comp = d.get("comp")
        o.clen = d.get("clen", 0)
        return o


class BlueStore(ObjectStore):
    def __init__(
        self,
        path: str,
        device_size: int = 1 << 30,
        block_size: int = 4096,
        inline_threshold: int = 4096,
        sync: bool = True,
        checksum: bool = True,
        compression: str = "none",
    ):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.block_size = block_size
        self.inline_threshold = inline_threshold
        self.checksum = checksum
        # at-rest data compression (reference: bluestore_compression —
        # whole-blob, kept only when it actually shrinks; metadata and
        # inline blobs stay raw)
        self._comp_name = compression if compression != "none" else None
        self._compressor = None
        if self._comp_name:
            from ..compressor import Compressor

            self._compressor = Compressor.create(self._comp_name)
        self._kv = None
        self._dev_path = os.path.join(path, "block")
        self._dev = None
        self._sync = sync
        self.n_blocks = device_size // block_size
        self._alloc = None
        self._colls: set[str] = set()
        self._onodes: dict[tuple[str, str], Onode] = {}
        self._lock = make_lock("store::bluestore")
        self._mounted = False
        self.mount()

    # -- device ------------------------------------------------------------
    def _dev_write(self, extents, data: bytes) -> list[int]:
        """Scatter `data` across `extents`; returns per-extent crc32c."""
        crcs = []
        off = 0
        for start, n in extents:
            part = data[off : off + n * self.block_size]
            self._dev.seek(start * self.block_size)
            self._dev.write(part)
            crcs.append(crc32c(part))
            off += n * self.block_size
        return crcs

    def _dev_read(self, onode: Onode, verify: bool | None = None) -> bytes:
        if onode.inline is not None:
            return onode.inline[: onode.size]
        parts = []
        for i, (start, n) in enumerate(onode.extents):
            self._dev.seek(start * self.block_size)
            part = self._dev.read(n * self.block_size)
            if (self.checksum if verify is None else verify) and \
                    i < len(onode.crcs):
                # the final extent's stored bytes may be shorter than the
                # block-rounded read when the device tail was never written
                part = part[: self._part_len(onode, i)]
                if crc32c(part) != onode.crcs[i]:
                    raise StoreError(
                        f"crc mismatch on extent {i} ({start},{n})"
                    )
            parts.append(part)
        stored = b"".join(parts)[: onode.stored_len()]
        if onode.comp:
            stored = self._decompressor(onode.comp).decompress(stored)
        return stored[: onode.size]

    def _decompressor(self, name: str):
        """Cached per-algorithm decompressor (a store reads objects
        compressed under any past knob setting, not just its own)."""
        if name == self._comp_name and self._compressor is not None:
            return self._compressor
        cache = getattr(self, "_decompressors", None)
        if cache is None:
            cache = self._decompressors = {}
        comp = cache.get(name)
        if comp is None:
            from ..compressor import Compressor

            comp = cache[name] = Compressor.create(name)
        return comp

    def _part_len(self, onode: Onode, i: int) -> int:
        """Bytes of payload stored in extent i (last extent may be
        partial); compressed blobs measure by their STORED length."""
        before = sum(
            n * self.block_size for _, n in onode.extents[:i]
        )
        return min(
            onode.extents[i][1] * self.block_size,
            max(0, onode.stored_len() - before),
        )

    # -- mount / freelist rebuild -----------------------------------------
    def mount(self) -> None:
        with self._lock:
            if self._mounted:
                return
            self._kv = LogKV(
                os.path.join(self.path, "kv"), sync_default=self._sync
            )
            if not os.path.exists(self._dev_path):
                with open(self._dev_path, "wb") as f:
                    f.truncate(self.n_blocks * self.block_size)
            self._dev = open(self._dev_path, "r+b")
            self._alloc = make_allocator(self.n_blocks)
            self._colls = {
                k.split(_SEP, 1)[1] for k, _ in self._kv.iterate("C" + _SEP)
            }
            self._onodes = {}
            for k, v in self._kv.iterate("N" + _SEP):
                _, cid, oid = k.split(_SEP, 2)
                onode = Onode.decode(v)
                self._onodes[(cid, oid)] = onode
                for start, n in onode.extents:
                    self._alloc.mark_used(start, n)
            for k, v in self._kv.iterate("A" + _SEP):
                _, cid, oid, name = k.split(_SEP, 3)
                o = self._onodes.get((cid, oid))
                if o is not None:
                    o.xattrs[name] = v
            for k, v in self._kv.iterate("O" + _SEP):
                _, cid, oid, key = k.split(_SEP, 3)
                o = self._onodes.get((cid, oid))
                if o is not None:
                    o.omap[key] = v
            self._mounted = True

    def umount(self) -> None:
        with self._lock:
            if not self._mounted:
                return
            self._kv.close()
            self._kv = None
            self._dev.close()
            self._dev = None
            self._mounted = False

    # -- transaction apply -------------------------------------------------
    def queue_transaction(
        self, t: Transaction, on_commit: Callable[[], None] | None = None
    ) -> None:
        # torn-write injection: see MemStore.queue_transaction
        self._fp_hit("osd.store.write_before_commit")
        with self._lock:
            self._apply_txn(t)
        self._fp_hit("osd.store.write_after_commit")
        if on_commit is not None:
            on_commit()

    def _materialize(self, staged, cid, oid, create=False):
        """Post-state working copy of an object for this transaction.

        Data bytes are LAZY: metadata-only ops (xattr/omap/touch) must not
        pay a device read + crc verify of a possibly-large payload, so
        st["data"] stays None until `_data()` is called by an op that
        actually edits bytes; st["size"] is valid either way."""
        key = (cid, oid)
        if key in staged:
            st = staged[key]
            if st is None and not create:
                raise NotFound(f"object {cid}/{oid}")
            if st is None:
                staged[key] = st = {
                    "data": bytearray(), "size": 0, "xattrs": {},
                    "omap": {}, "dirty_data": True, "key": key,
                }
            return st
        onode = self._onodes.get(key)
        if onode is None:
            if not create:
                raise NotFound(f"object {cid}/{oid}")
            staged[key] = st = {
                "data": bytearray(), "size": 0, "xattrs": {}, "omap": {},
                "dirty_data": True, "key": key,
            }
            return st
        staged[key] = st = {
            "data": None, "size": onode.size,
            "xattrs": dict(onode.xattrs),
            "omap": dict(onode.omap),
            "dirty_data": False, "key": key,
        }
        return st

    def _data(self, st) -> bytearray:
        """Materialize the staged object's bytes (device read on first
        data-touching op)."""
        if st["data"] is None:
            onode = self._onodes.get(st["key"])
            st["data"] = bytearray(
                self._dev_read(onode) if onode is not None else b""
            )
        return st["data"]

    def _require_coll(self, colls, cid):
        if cid not in colls:
            raise NotFound(f"collection {cid}")

    def _apply_txn(self, t: Transaction) -> None:
        # phase 1: compute post-state in RAM (all-or-nothing on error)
        colls = set(self._colls)
        staged: dict[tuple[str, str], dict | None] = {}
        for op in t.ops:
            if op.op == OP_MKCOLL:
                if op.cid in colls:
                    raise StoreError(f"collection {op.cid} exists")
                colls.add(op.cid)
            elif op.op == OP_TRY_MKCOLL:
                colls.add(op.cid)
            elif op.op == OP_RMCOLL:
                if op.cid not in colls:
                    raise NotFound(f"collection {op.cid}")
                live = any(
                    k[0] == op.cid and staged.get(k, True) is not None
                    for k in set(self._onodes) | set(staged)
                )
                if live:
                    raise StoreError(f"collection {op.cid} not empty")
                colls.discard(op.cid)
            elif op.op == OP_TOUCH:
                self._require_coll(colls, op.cid)
                self._materialize(staged, op.cid, op.oid, create=True)
            elif op.op == OP_WRITE:
                self._require_coll(colls, op.cid)
                st = self._materialize(staged, op.cid, op.oid, create=True)
                data = self._data(st)
                end = op.off + len(op.data)
                if len(data) < end:
                    data.extend(b"\0" * (end - len(data)))
                data[op.off : end] = op.data
                st["dirty_data"] = True
            elif op.op == OP_ZERO:
                self._require_coll(colls, op.cid)
                st = self._materialize(staged, op.cid, op.oid)
                data = self._data(st)
                end = op.off + op.length
                if len(data) < end:
                    data.extend(b"\0" * (end - len(data)))
                data[op.off : end] = b"\0" * op.length
                st["dirty_data"] = True
            elif op.op == OP_TRUNCATE:
                self._require_coll(colls, op.cid)
                st = self._materialize(staged, op.cid, op.oid)
                data = self._data(st)
                size = op.off
                if len(data) > size:
                    del data[size:]
                else:
                    data.extend(b"\0" * (size - len(data)))
                st["dirty_data"] = True
            elif op.op == OP_REMOVE:
                self._require_coll(colls, op.cid)
                self._materialize(staged, op.cid, op.oid)
                staged[(op.cid, op.oid)] = None
            elif op.op == OP_SETATTR:
                self._require_coll(colls, op.cid)
                st = self._materialize(staged, op.cid, op.oid)
                st["xattrs"][op.name] = op.data
            elif op.op == OP_RMATTR:
                self._require_coll(colls, op.cid)
                st = self._materialize(staged, op.cid, op.oid)
                st["xattrs"].pop(op.name, None)
            elif op.op == OP_OMAP_SETKEYS:
                self._require_coll(colls, op.cid)
                st = self._materialize(staged, op.cid, op.oid)
                st["omap"].update(op.keys)
            elif op.op == OP_OMAP_RMKEYS:
                self._require_coll(colls, op.cid)
                st = self._materialize(staged, op.cid, op.oid)
                for k in op.keys:
                    st["omap"].pop(k, None)
            elif op.op == OP_OMAP_CLEAR:
                self._require_coll(colls, op.cid)
                st = self._materialize(staged, op.cid, op.oid)
                st["omap"].clear()
            elif op.op == OP_COLL_MOVE_RENAME:
                self._require_coll(colls, op.cid)
                self._require_coll(colls, op.dest_cid)
                st = self._materialize(staged, op.cid, op.oid)
                data = bytearray(self._data(st))
                staged[(op.cid, op.oid)] = None
                staged[(op.dest_cid, op.dest_oid)] = {
                    "data": data,
                    "size": len(data),
                    "xattrs": dict(st["xattrs"]),
                    "omap": dict(st["omap"]),
                    "dirty_data": True,
                    "key": (op.dest_cid, op.dest_oid),
                }
            else:
                raise StoreError(f"unknown transaction op {op.op}")

        # phase 2: write dirty data to fresh extents (COW), fdatasync
        batch = Batch()
        new_extents: dict[tuple[str, str], tuple] = {}
        allocated: list[tuple[int, int]] = []
        try:
            for key, st in staged.items():
                if st is None or not st["dirty_data"]:
                    continue
                data = bytes(st["data"])
                if len(data) <= self.inline_threshold:
                    new_extents[key] = (data, [], [], None, 0)
                    continue
                comp_name = None
                stored = data
                if self._compressor is not None:
                    packed = self._compressor.compress(data)
                    # keep compression only when it saves whole blocks —
                    # the allocation granularity (reference: blobs are
                    # kept raw unless the required_ratio is met)
                    if (-(-len(packed) // self.block_size)
                            < -(-len(data) // self.block_size)):
                        stored = packed
                        comp_name = self._comp_name
                want = -(-len(stored) // self.block_size)
                extents = self._alloc.allocate(want)
                allocated.extend(extents)
                crcs = self._dev_write(extents, stored)
                new_extents[key] = (None, extents, crcs, comp_name,
                                    len(stored))
            if any(e for _, e, _c, _n, _l in new_extents.values()):
                self._dev.flush()
                if self._sync:
                    os.fdatasync(self._dev.fileno())
        except Exception:
            for s, n in allocated:
                self._alloc.release(s, n)
            raise

        # phase 3: one atomic KV batch
        for cid in colls - self._colls:
            batch.set(_ckey(cid), b"1")
        for cid in self._colls - colls:
            batch.rm(_ckey(cid))
        freed: list[tuple[int, int]] = []
        new_onodes: dict[tuple[str, str], Onode] = {}
        for key, st in staged.items():
            cid, oid = key
            old = self._onodes.get(key)
            if st is None:
                if old is not None:
                    batch.rm(_nkey(cid, oid))
                    for name in old.xattrs:
                        batch.rm(_akey(cid, oid, name))
                    for k in old.omap:
                        batch.rm(_okey(cid, oid, k))
                    freed.extend(old.extents)
                continue
            onode = Onode()
            onode.size = (
                len(st["data"]) if st["dirty_data"] else st["size"]
            )
            if key in new_extents:
                inline, extents, crcs, comp, clen = new_extents[key]
                onode.inline = inline
                onode.extents = extents
                onode.crcs = crcs
                onode.comp = comp
                onode.clen = clen
                if old is not None:
                    freed.extend(old.extents)
            elif old is not None:
                onode.inline = old.inline
                onode.extents = old.extents
                onode.crcs = old.crcs
                onode.comp = old.comp
                onode.clen = old.clen
            onode.xattrs = dict(st["xattrs"])
            onode.omap = dict(st["omap"])
            batch.set(_nkey(cid, oid), onode.encode())
            old_x = old.xattrs if old else {}
            for name in set(old_x) - set(onode.xattrs):
                batch.rm(_akey(cid, oid, name))
            for name, v in onode.xattrs.items():
                if old_x.get(name) != v:
                    batch.set(_akey(cid, oid, name), v)
            old_o = old.omap if old else {}
            for k in set(old_o) - set(onode.omap):
                batch.rm(_okey(cid, oid, k))
            for k, v in onode.omap.items():
                if old_o.get(k) != v:
                    batch.set(_okey(cid, oid, k), v)
            new_onodes[key] = onode
        try:
            self._kv.submit_batch(batch, sync=self._sync)
        except Exception:
            # KV failed: the new COW extents are unreferenced — reclaim
            for s, n in allocated:
                self._alloc.release(s, n)
            raise

        # phase 4: RAM state + release replaced extents (only after the KV
        # committed, so the switch is all-or-nothing)
        self._colls = colls
        self._onodes.update(new_onodes)
        for key, st in staged.items():
            if st is None:
                self._onodes.pop(key, None)
        for s, n in freed:
            self._alloc.release(s, n)

    # -- reads -------------------------------------------------------------
    def _get(self, cid: str, oid: str) -> Onode:
        if cid not in self._colls:
            raise NotFound(f"collection {cid}")
        o = self._onodes.get((cid, oid))
        if o is None:
            raise NotFound(f"object {cid}/{oid}")
        return o

    def read(self, cid: str, oid: str, off: int = 0, length: int = -1) -> bytes:
        with self._lock:
            data = self._dev_read(self._get(cid, oid))
        if length < 0:
            return data[off:]
        return data[off : off + length]

    def stat(self, cid: str, oid: str) -> dict:
        with self._lock:
            o = self._get(cid, oid)
            return {"size": o.size}

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        with self._lock:
            o = self._get(cid, oid)
            if name not in o.xattrs:
                raise NotFound(f"xattr {name}")
            return o.xattrs[name]

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            return dict(self._get(cid, oid).xattrs)

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            return dict(self._get(cid, oid).omap)

    def list_collections(self) -> list[str]:
        with self._lock:
            return sorted(self._colls)

    def list_objects(self, cid: str) -> list[str]:
        with self._lock:
            if cid not in self._colls:
                raise NotFound(f"collection {cid}")
            return sorted(o for c, o in self._onodes if c == cid)

    def collection_bytes(self, cid: str) -> int:
        with self._lock:
            return sum(
                onode.size for (c, o), onode in self._onodes.items()
                if c == cid and not o.startswith("_")
            )

    def statfs(self) -> dict:
        # allocator truth, not onode sums: compression and block
        # rounding make logical size diverge from device usage
        total = self.n_blocks * self.block_size
        with self._lock:
            free = (self._alloc.free_blocks * self.block_size
                    if self._alloc else total)
        return {"total": total, "used": total - free, "avail": free}

    def collections_bytes(self) -> dict[str, int]:
        # single pass over the onode index (collection_bytes per cid
        # would rescan all onodes once per collection)
        with self._lock:
            out = {cid: 0 for cid in self._colls}
            for (c, o), onode in self._onodes.items():
                if not o.startswith("_") and c in out:
                    out[c] += onode.size
            return out

    # -- fsck --------------------------------------------------------------
    def fsck(self, deep: bool = False, repair: bool = False) -> dict:
        """Extent audit + optional data crc verify (reference:
        BlueStore::_fsck / ceph-bluestore-tool).  Returns a report; with
        repair=True leaked blocks are reclaimed (they already are at
        mount; this validates the invariant on a live store)."""
        with self._lock:
            report = {
                "objects": len(self._onodes),
                "errors": [],
                "leaked_blocks": 0,
            }
            used = {}
            for key, onode in self._onodes.items():
                seen = 0
                for start, n in onode.extents:
                    if start + n > self.n_blocks:
                        report["errors"].append(
                            f"{key}: extent ({start},{n}) out of range"
                        )
                        continue
                    for b in range(start, start + n):
                        if b in used:
                            report["errors"].append(
                                f"{key}: block {b} also used by {used[b]}"
                            )
                        used[b] = key
                    seen += n * self.block_size
                if onode.inline is None and seen < onode.stored_len():
                    report["errors"].append(
                        f"{key}: extents cover {seen} < stored "
                        f"{onode.stored_len()}"
                    )
                if deep:
                    try:
                        self._dev_read(onode, verify=True)
                    except StoreError as e:
                        report["errors"].append(f"{key}: {e}")
            report["used_blocks"] = len(used)
            report["free_blocks"] = self._alloc.free_blocks
            leaked = self.n_blocks - len(used) - self._alloc.free_blocks
            report["leaked_blocks"] = leaked
            if repair and leaked:
                # rebuild the freelist from the onode walk (what mount
                # does): fresh allocator, re-mark referenced extents
                self._alloc = make_allocator(self.n_blocks)
                for onode in self._onodes.values():
                    for start, n in onode.extents:
                        self._alloc.mark_used(start, n)
                report["repaired"] = leaked
                report["free_blocks"] = self._alloc.free_blocks
            return report
