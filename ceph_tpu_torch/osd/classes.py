"""Object classes — server-side op extensions (reference: src/objclass +
src/cls; `rados exec` in librados; SURVEY.md §2.6).

A class method runs AT THE PRIMARY, under the PG lock, against one
object: it reads the object's current state through a `ClsHandle` and
stages mutations that commit as ONE replicated, logged transaction after
the method returns.  That primary-side atomicity is the entire point —
e.g. the bucket-index update cls_rgw performs server-side cannot be
raced by a second gateway the way client-side read-modify-write can.

Contract (mirrors objclass.h, minus the C plumbing):

    def method(hctx: ClsHandle, inp: dict) -> tuple[int, object]:
        ...
    ClassRegistry.instance().register("mycls", "mymethod", method)

- `inp` and the returned payload must be JSON-serializable (they ride
  the MOSDOp/MOSDOpReply wire).
- retval < 0 aborts: staged mutations are DISCARDED and the retval goes
  back to the client (e.g. -17 EEXIST for a failed create guard).
- Methods must be deterministic state transforms of (object, inp) —
  they may be re-run on a client resend that lost its reply (the dup
  cache answers applied resends, but a method that consults wall-clock
  or randomness would still diverge across primaries).

Built-ins registered at import:

- `rgw` (reference: src/cls/rgw — the bucket-index class):
  `dir_entry_create`  {key, val}            -17 if key exists
  `dir_entry_remove`  {key}                 -2 if absent
  `index_update`      {add: {k: v}, rm: [k], guard_absent: [k]}
                      atomic multi-key set+remove; -17 if any guard key
                      is present; -2 if the index is sealed
  `bucket_seal`       {}                    atomic check-empty +
                      tombstone; -39 ENOTEMPTY if entries remain
  `bucket_init`       {}                    reset a (re)created bucket's
                      index: clears seals and ghost entries
- `counter` (test/demo of primary-side atomicity, the hello.cc role):
  `incr`              {key, delta}          returns the new value
"""
from __future__ import annotations

import json


class ClsHandle:
    """Per-invocation object view + mutation stager (reference:
    cls_method_context_t).  Reads see the object's committed state;
    writes stage into `omap_set`/`omap_rm`/`data` for the caller
    (_exec_op) to commit atomically."""

    def __init__(self, oid: str, read_data, read_omap):
        self.oid = oid
        self._read_data = read_data
        self._read_omap = read_omap
        self.staged_set: dict[str, bytes] = {}
        self.staged_rm: set[str] = set()
        self.staged_data: bytes | None = None

    # -- reads -------------------------------------------------------------
    def read(self) -> bytes | None:
        """Object data; None when the object does not exist."""
        if self.staged_data is not None:
            return self.staged_data
        return self._read_data()

    def omap_get(self, keys=None) -> dict[str, bytes]:
        """Committed omap overlaid with this invocation's staged state
        (a method observes its own writes, like a cls transaction)."""
        kv = dict(self._read_omap())
        for k in self.staged_rm:
            kv.pop(k, None)
        kv.update(self.staged_set)
        if keys is not None:
            return {k: kv[k] for k in keys if k in kv}
        return kv

    # -- staged writes -----------------------------------------------------
    def write_full(self, data: bytes) -> None:
        self.staged_data = bytes(data)

    def omap_set(self, kv: dict[str, bytes]) -> None:
        for k, v in kv.items():
            self.staged_rm.discard(k)
            self.staged_set[k] = bytes(v)

    def omap_rm(self, keys) -> None:
        for k in keys:
            self.staged_set.pop(k, None)
            self.staged_rm.add(k)

    @property
    def dirty(self) -> bool:
        return bool(self.staged_set or self.staged_rm
                    or self.staged_data is not None)


class ClassRegistry:
    """Process-global method table (reference: ClassHandler; classes load
    once per OSD process)."""

    _instance: "ClassRegistry | None" = None

    def __init__(self):
        self._methods: dict[tuple[str, str], object] = {}

    @classmethod
    def instance(cls) -> "ClassRegistry":
        if cls._instance is None:
            cls._instance = ClassRegistry()
            _register_builtins(cls._instance)
        return cls._instance

    def register(self, cls_name: str, method: str, fn) -> None:
        self._methods[(cls_name, method)] = fn

    def get(self, cls_name: str, method: str):
        """None when unknown — the OSD answers -EOPNOTSUPP, like the
        reference's class-load failure."""
        return self._methods.get((cls_name, method))


# ---------------------------------------------------------------- built-ins

def _rgw_dir_entry_create(hctx: ClsHandle, inp: dict):
    """Create-if-absent — the atomic 'claim' two concurrent gateways race
    for (reference: cls_rgw bucket creation guards)."""
    key = inp["key"]
    if key in hctx.omap_get(keys=[key]):
        return -17, f"entry {key!r} exists"
    hctx.omap_set({key: json.dumps(inp.get("val")).encode()})
    return 0, None


def _rgw_dir_entry_remove(hctx: ClsHandle, inp: dict):
    key = inp["key"]
    if key not in hctx.omap_get(keys=[key]):
        return -2, f"no entry {key!r}"
    hctx.omap_rm([key])
    return 0, None


# reserved omap key marking a sealed (deleted) bucket index; sorts below
# every printable object key so listings naturally skip it
SEALED_KEY = "\x01sealed"


def _rgw_index_update(hctx: ClsHandle, inp: dict):
    """Transactional multi-key index mutation (reference: cls_rgw
    bucket-index complete ops): adds + removes land atomically, optional
    guards refuse the whole batch if a key already exists, and adds are
    refused outright on a SEALED index (a concurrently deleted bucket) —
    the check and the mutation share one PG-lock critical section, so a
    PUT can never land an entry in a bucket another gateway deleted."""
    add = inp.get("add") or {}
    if add and SEALED_KEY in hctx.omap_get(keys=[SEALED_KEY]):
        return -2, "bucket index sealed (bucket deleted)"
    for key in inp.get("guard_absent") or []:
        if key in hctx.omap_get(keys=[key]):
            return -17, f"guard: entry {key!r} exists"
    hctx.omap_set({k: json.dumps(v).encode() for k, v in add.items()})
    rm = inp.get("rm") or []
    hctx.omap_rm(rm)
    return 0, {"added": len(add), "removed": len(rm)}


def _rgw_bucket_seal(hctx: ClsHandle, inp: dict):
    """Atomic check-empty-and-tombstone (reference: cls_rgw's bucket
    removal guards): refuses with -39 ENOTEMPTY if any live entry
    remains, else marks the index sealed so racing adds fail.  The whole
    op runs under the PG lock, closing the check-then-delete window a
    client-side emptiness test leaves open."""
    live = [k for k in hctx.omap_get() if not k.startswith("\x01")]
    if live:
        return -39, {"entries": len(live)}
    hctx.omap_set({SEALED_KEY: b"1"})
    return 0, None


def _rgw_bucket_init(hctx: ClsHandle, inp: dict):
    """Reset an index object for a (re)created bucket: drops a stale
    seal and any ghost entries a half-completed delete left behind."""
    hctx.omap_rm(list(hctx.omap_get()))
    hctx.write_full(b"")
    return 0, None


def _counter_incr(hctx: ClsHandle, inp: dict):
    """Atomic read-modify-write under the PG lock — the op that LOSES
    updates when done client-side by two concurrent writers."""
    key = inp.get("key", "value")
    cur = hctx.omap_get(keys=[key]).get(key)
    val = (int(cur) if cur else 0) + int(inp.get("delta", 1))
    hctx.omap_set({key: str(val).encode()})
    return 0, {"value": val}


def _register_builtins(reg: ClassRegistry) -> None:
    reg.register("rgw", "dir_entry_create", _rgw_dir_entry_create)
    reg.register("rgw", "dir_entry_remove", _rgw_dir_entry_remove)
    reg.register("rgw", "index_update", _rgw_index_update)
    reg.register("rgw", "bucket_seal", _rgw_bucket_seal)
    reg.register("rgw", "bucket_init", _rgw_bucket_init)
    reg.register("counter", "incr", _counter_incr)
