"""ceph_tpu_torch.store — local object storage (reference: src/os, src/kv;
SURVEY.md §2.4).

ObjectStore is the transactional object API the OSD data plane writes
through (reference: src/os/ObjectStore.h :: queue_transaction /
Transaction).  Backends:

- MemStore: in-RAM, the unit-test backend (reference: src/os/memstore).
- KStore: crash-safe file-backed store — every Transaction becomes one
  atomic, crc-protected WAL batch in a log-structured KV (reference role:
  BlueStore's RocksDB-WAL commit path, src/os/bluestore; the KV design is
  the analog of src/kv/RocksDBStore over BlueFS).

Collections are PGs, exactly as in the reference.
"""
from .kv import KeyValueDB, LogKV
from .object_store import (
    Collection,
    NotFound,
    ObjectStore,
    StoreError,
    Transaction,
    create_store,
)
from .memstore import MemStore
from .kstore import KStore

__all__ = [
    "Collection",
    "KStore",
    "KeyValueDB",
    "LogKV",
    "MemStore",
    "NotFound",
    "ObjectStore",
    "StoreError",
    "Transaction",
    "create_store",
]
