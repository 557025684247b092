"""Rados / IoCtx — the librados-analog public client API (reference:
src/include/rados/librados.hpp :: Rados/IoCtx, src/librados/RadosClient.cc;
SURVEY.md §2.6).

    r = Rados(cct, mon_addrs)
    r.connect()
    io = r.open_ioctx("mypool")
    io.write_full("obj", b"bytes")
    io.read("obj")
    r.shutdown()
"""
from __future__ import annotations

from ..mon.mon_client import MonClient
from ..osd.messages import pack_data, unpack_data
from .objecter import Objecter


class IoCtx:
    """Per-pool I/O context (reference: librados::IoCtx)."""

    def __init__(self, client: "Rados", pool_id: int, pool_name: str):
        self._client = client
        self.pool_id = pool_id
        self.pool_name = pool_name

    def write_full(self, oid: str, data: bytes,
                   snapc_seq: int = 0) -> int:
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "write_full", data=bytes(data),
            snapc_seq=snapc_seq,
        )
        if rep.retval != 0:
            raise IOError(f"write_full {oid!r}: {rep.retval} {rep.result}")
        return rep.retval

    def write(self, oid: str, data: bytes, off: int = 0) -> int:
        """Ranged write (reference: rados_write): splices `data` into the
        object at `off`, growing it if needed; a gap below `off` on a new
        object reads back as zeros.  On EC pools this is the
        partial-stripe RMW path (parity-delta update)."""
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "write", data=bytes(data), off=off
        )
        if rep.retval != 0:
            raise IOError(f"write {oid!r}@{off}: {rep.retval} {rep.result}")
        return rep.retval

    def append(self, oid: str, data: bytes) -> int:
        """reference: rados_append — write at the current object size."""
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "append", data=bytes(data)
        )
        if rep.retval != 0:
            raise IOError(f"append {oid!r}: {rep.retval} {rep.result}")
        return rep.retval

    def read(self, oid: str, off: int = 0, length: int = 0,
             snapid: int | None = None) -> bytes:
        """`snapid` reads the pool-snapshot view (reference: IoCtx
        snap_set_read + read)."""
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "read", off=off, length=length,
            snapid=snapid,
        )
        if rep.retval != 0:
            raise IOError(f"read {oid!r}: {rep.retval} {rep.result}")
        return unpack_data(rep.data) or b""

    # -- cache tiering (reference: rados cache-flush / cache-evict ops;
    # this IoCtx must be open on the CACHE pool) --------------------------
    def cache_flush(self, oid: str) -> object:
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "cache_flush", ignore_overlay=True
        )
        if rep.retval != 0:
            raise IOError(f"cache_flush {oid!r}: {rep.retval} {rep.result}")
        return rep.result

    def cache_evict(self, oid: str) -> object:
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "cache_evict", ignore_overlay=True
        )
        if rep.retval != 0:
            raise IOError(f"cache_evict {oid!r}: {rep.retval} {rep.result}")
        return rep.result

    # -- omap (reference: rados_omap_* — replicated pools only) -----------
    def exec(self, oid: str, cls: str, method: str,
             inp: dict | None = None) -> tuple[int, object]:
        """Run a server-side object-class method at the object's primary
        (reference: rados_exec / librados::IoCtx::exec; classes in
        ceph_tpu/osd/classes.py).  Returns (retval, out) — retval < 0 is
        the METHOD's verdict (e.g. -17 for a failed create guard), which
        callers branch on; transport/cluster failures raise IOError."""
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "exec",
            data={"cls": cls, "method": method, "in": inp or {}},
        )
        # method verdicts come back wrapped in "cls_out"; anything else
        # with a non-zero retval is a cluster-side refusal (unknown
        # class, EC pool, no pool, min_size)
        if isinstance(rep.result, dict) and "cls_out" in rep.result:
            return rep.retval, rep.result["cls_out"]
        if rep.retval == 0:
            return 0, rep.result  # dup-cache resend of an applied exec
        raise IOError(f"exec {oid!r} {cls}.{method}: "
                      f"{rep.retval} {rep.result}")

    def omap_set(self, oid: str, kv: dict[str, bytes]) -> None:
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "omap_set",
            data={"keys": {k: pack_data(bytes(v)) for k, v in kv.items()}},
        )
        if rep.retval != 0:
            raise IOError(f"omap_set {oid!r}: {rep.retval} {rep.result}")

    def omap_get(self, oid: str, keys=None) -> dict[str, bytes]:
        """All pairs (keys=None) or just `keys` (reference:
        omap_get_vals_by_keys)."""
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "omap_get",
            data={"keys": list(keys) if keys is not None else None},
        )
        if rep.retval != 0:
            raise IOError(f"omap_get {oid!r}: {rep.retval} {rep.result}")
        return {k: unpack_data(v) for k, v in rep.result["kv"].items()}

    def omap_get_vals(self, oid: str, after: str = "",
                      max_return: int = 512) -> dict[str, bytes]:
        """Paginated scan: keys strictly greater than `after`, up to
        `max_return` (reference: rados_omap_get_vals)."""
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "omap_get",
            data={"after": after, "max": max_return},
        )
        if rep.retval != 0:
            raise IOError(f"omap_get_vals {oid!r}: {rep.retval} {rep.result}")
        return {k: unpack_data(v) for k, v in rep.result["kv"].items()}

    def omap_rm_keys(self, oid: str, keys) -> None:
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "omap_rm", data={"keys": list(keys)},
        )
        if rep.retval != 0:
            raise IOError(f"omap_rm {oid!r}: {rep.retval} {rep.result}")

    def omap_clear(self, oid: str) -> None:
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "omap_clear", data={},
        )
        if rep.retval != 0:
            raise IOError(f"omap_clear {oid!r}: {rep.retval} {rep.result}")

    # -- watch / notify (reference: rados_watch3 / rados_notify2) ---------
    def watch(self, oid: str, callback) -> int:
        """Register a watch; `callback(notify_id, cookie, data: bytes)`
        fires for each notify.  Returns the watch cookie.  The watch
        lingers: the Objecter re-registers it after a map change, so it
        survives primary failover (reference: linger ops)."""
        return self._client.objecter.watch(self.pool_id, oid, callback)

    def unwatch(self, oid: str, cookie: int) -> None:
        self._client.objecter.unwatch(self.pool_id, oid, cookie)

    def notify(self, oid: str, data: bytes = b"",
               timeout: float = 5.0) -> dict:
        """Fire a notify and collect watcher acks; returns
        {"acked": [cookies], "missed": [cookies]}."""
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "notify",
            data={"payload": pack_data(bytes(data)), "timeout": timeout},
            timeout=max(30.0, timeout + 10.0),
        )
        if rep.retval != 0:
            raise IOError(f"notify {oid!r}: {rep.retval} {rep.result}")
        return rep.result

    # -- pool snapshots (reference: rados_ioctx_snap_create/remove etc.) --
    def _pool(self):
        m = self._client.mc.osdmap
        if m is None or self.pool_id not in m.pools:
            raise IOError(f"pool {self.pool_id} not in the current map")
        return m.pools[self.pool_id]

    def snap_create(self, name: str) -> int:
        rv, res = self._client.command({
            "prefix": "osd pool mksnap",
            "name": self.pool_name, "snapname": name,
        })
        if rv != 0:
            raise IOError(f"mksnap {name!r}: {rv} {res}")
        sid = res["snapid"]
        # block until OUR map carries the snap: the next write's snap
        # context must include it (reference: librados waits for the
        # map epoch the mon committed)
        self._wait_map(lambda p: p.snap_seq >= sid)
        return sid

    def snap_remove(self, name: str) -> None:
        rv, res = self._client.command({
            "prefix": "osd pool rmsnap",
            "name": self.pool_name, "snapname": name,
        })
        if rv != 0:
            raise IOError(f"rmsnap {name!r}: {rv} {res}")
        removed = res["removed"]
        self._wait_map(lambda p: removed not in p.snaps)

    def _wait_map(self, pred, timeout: float = 10.0) -> None:
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            m = self._client.mc.osdmap
            p = m.pools.get(self.pool_id) if m is not None else None
            if p is not None and pred(p):
                return
            e = m.epoch if m else 0
            try:
                self._client.mc.wait_for_osdmap(
                    min_epoch=e + 1, timeout=1.0
                )
            except TimeoutError:
                pass
        raise IOError("timed out waiting for the snap map epoch")

    def snap_list(self) -> dict[int, str]:
        self._client.mc.wait_for_osdmap(timeout=10.0)
        return dict(self._pool().snaps)

    def snap_lookup(self, name: str) -> int:
        for sid, n in self.snap_list().items():
            if n == name:
                return sid
        raise KeyError(f"no snap {name!r}")

    def snap_rollback(self, oid: str, snapname: str) -> None:
        """reference: rados_ioctx_snap_rollback — restore the head to the
        snapshot's content (client-side: snap read then write_full)."""
        self.write_full(oid, self.read(oid, snapid=self.snap_lookup(snapname)))

    def remove(self, oid: str, snapc_seq: int = 0) -> None:
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "delete", snapc_seq=snapc_seq)
        if rep.retval != 0:
            raise IOError(f"remove {oid!r}: {rep.retval} {rep.result}")

    def stat(self, oid: str) -> dict:
        rep = self._client.objecter.op_submit(self.pool_id, oid, "stat")
        if rep.retval != 0:
            raise IOError(f"stat {oid!r}: {rep.retval} {rep.result}")
        return rep.result

    def set_xattr(self, oid: str, name: str, value: bytes) -> None:
        """reference: rados_setxattr."""
        from ..osd.messages import pack_data

        if name.startswith("_"):
            raise IOError(
                f"xattr {name!r}: '_'-prefixed names are reserved for "
                "framework metadata (snapshot bookkeeping)"
            )
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "setxattr",
            data={name: pack_data(bytes(value))},
        )
        if rep.retval != 0:
            raise IOError(f"setxattr {oid!r}: {rep.retval} {rep.result}")

    def rm_xattr(self, oid: str, name: str) -> None:
        """reference: rados_rmxattr."""
        if name.startswith("_"):
            raise IOError(f"xattr {name!r}: '_'-prefixed names are reserved")
        rep = self._client.objecter.op_submit(
            self.pool_id, oid, "setxattr", data={name: None}
        )
        if rep.retval != 0:
            raise IOError(f"rm_xattr {oid!r}: {rep.retval} {rep.result}")

    def get_xattrs(self, oid: str) -> dict[str, bytes]:
        """reference: rados_getxattrs."""
        rep = self._client.objecter.op_submit(self.pool_id, oid, "getxattrs")
        if rep.retval != 0:
            raise IOError(f"getxattrs {oid!r}: {rep.retval} {rep.result}")
        return {
            k: unpack_data(v) for k, v in (rep.result or {}).items()
            if not k.startswith("_")  # '_'-names are framework-internal
        }

    def get_xattr(self, oid: str, name: str) -> bytes:
        attrs = self.get_xattrs(oid)
        if name not in attrs:
            raise KeyError(name)
        return attrs[name]

    def scrub_pg(self, ps: int, repair: bool = True) -> dict:
        """Deep-scrub one PG on its primary; returns the scrub report.
        repair=False inspects only — divergent replicas are reported,
        not rewritten (reference: `ceph pg deep-scrub` vs `pg repair`
        reaching the primary)."""
        rep = self._client.objecter.op_submit(
            self.pool_id, f":pg:{ps}",
            "scrub" if repair else "scrub-noprepair", timeout=60.0
        )
        if rep.retval != 0:
            raise IOError(f"scrub pg {ps}: {rep.retval} {rep.result}")
        return rep.result

    def scrub(self) -> list[dict]:
        """Deep-scrub every PG of the pool."""
        m = self._client.mc.osdmap
        pool = m.pools[self.pool_id]
        return [self.scrub_pg(ps) for ps in range(pool.pg_num)]

    def list_objects(self) -> list[str]:
        """Walk every PG primary (reference: librados nobjects_begin)."""
        m = self._client.mc.osdmap
        pool = m.pools[self.pool_id]
        oids: set[str] = set()
        for ps in range(pool.pg_num):
            rep = self._client.objecter.op_submit(
                self.pool_id, f":pg:{ps}", "list"
            )
            if rep.retval == 0 and isinstance(rep.result, dict):
                oids.update(rep.result.get("oids") or [])
        return sorted(oids)


class Rados:
    """reference: librados::Rados — cluster handle."""

    def __init__(self, cct, mon_addrs, name: str = "client.admin"):
        self.cct = cct
        self.mc = MonClient(cct, mon_addrs, name=name)
        self.objecter: Objecter | None = None
        self._name = name

    def connect(self, timeout: float = 15.0) -> None:
        self.objecter = Objecter(self.cct, self.mc, name=self._name)
        self.mc.wait_for_osdmap(timeout=timeout)

    def shutdown(self) -> None:
        if self.objecter is not None:
            self.objecter.shutdown()
        self.mc.shutdown()

    def command(self, cmd: dict, timeout: float = 15.0):
        """Mon command passthrough (the `ceph` CLI surface)."""
        return self.mc.command(cmd, timeout=timeout)

    def pool_id(self, name: str) -> int:
        m = self.mc.osdmap
        if m is None:
            raise ConnectionError("not connected")
        for pid, p in m.pools.items():
            if p.name == name:
                return pid
        raise KeyError(f"no pool {name!r}")

    def open_ioctx(self, pool: str | int) -> IoCtx:
        if isinstance(pool, str):
            pid = self.pool_id(pool)
            return IoCtx(self, pid, pool)
        pname = self.mc.osdmap.pools[pool].name if self.mc.osdmap else str(pool)
        return IoCtx(self, pool, pname)
