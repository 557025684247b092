"""The GF(2^8) matrix-apply seam — counterpart of ceph_tpu/ops/bitplane.py.

Every codec's device work goes through ``apply_matrix`` or
``fused_encode``: a [rows, n] GF(2^8) matrix applied to [n, L] byte
shards.  On ``cuda`` they launch the hand-written kernels of
ops/gf_kernels.py (K1 or K2, by the rule stated there); on ``cpu``
(asked for explicitly) they run its plain PyTorch version.  There is one
path per device: no kernel policy, no fallback latch, no second
implementation on the card.

Data layout is whole shards [k, shard_len] (chunk j of every stripe is
contiguous on shard j, as ECBackend lays out shards, reference:
src/osd/ECUtil.h :: stripe_info_t), so one apply covers every stripe of
an object.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from threading import Lock

import numpy as np
import torch

from ..common.device import as_bytes_tensor, resolve_device
from ..gf.matrix import decode_matrix_for, systematic_generator
from .gf_kernels import gf_apply, nibble_tables


def matrix_digest(mat: np.ndarray) -> str:
    """Stable identity of a coding matrix (shape + bytes), computed once per
    codec or cached decode matrix and used as the table-cache key."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    h = hashlib.sha1(repr(mat.shape).encode())
    h.update(mat.tobytes())
    return h.hexdigest()


class TableCache:
    """Bounded LRU of the kernels' split-nibble tables on the device, keyed
    by (matrix digest, device): a hot matrix is expanded and copied to the
    card once."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._tables: OrderedDict[tuple[str, str], torch.Tensor] = OrderedDict()
        self._lock = Lock()

    def get(self, mat: np.ndarray, device: torch.device,
            mat_key: str | None = None) -> torch.Tensor:
        key = (mat_key or matrix_digest(mat), str(device))
        with self._lock:
            tab = self._tables.get(key)
            if tab is not None:
                self._tables.move_to_end(key)
                return tab
        tab = torch.from_numpy(nibble_tables(mat)).to(device)
        with self._lock:
            self._tables[key] = tab
            self._tables.move_to_end(key)
            while len(self._tables) > self.maxsize:
                self._tables.popitem(last=False)
        return tab


#: the process's table cache (bounded; tables are a few KiB each)
TABLES = TableCache()


def _apply(mat: np.ndarray, segments: list[torch.Tensor], device: torch.device,
           mat_key: str | None) -> torch.Tensor:
    tables = TABLES.get(mat, device, mat_key) if device.type == "cuda" else None
    return gf_apply(mat, segments, tables=tables)


def apply_matrix(mat: np.ndarray, chunks, device=None,
                 mat_key: str | None = None) -> torch.Tensor:
    """GF(2^8) ``mat [rows, n]`` times ``chunks [n, L]`` -> [rows, L] uint8
    tensor on `device` (``cuda`` unless ``device="cpu"``).  `chunks` may be
    a tensor or a numpy array; `mat_key` is the codec's precomputed
    ``matrix_digest(mat)``."""
    dev = resolve_device(device)
    x = as_bytes_tensor(chunks, dev)
    if x.dim() != 2:
        raise ValueError(f"chunks must be [n, L], got {tuple(x.shape)}")
    return _apply(np.asarray(mat), [x], dev, mat_key)


def fused_encode(mat: np.ndarray, chunks_list, device=None,
                 mat_key: str | None = None) -> torch.Tensor:
    """Several [k, L_s] stripes -> ONE [m, sum L_s] parity tensor in ONE
    kernel launch (counterpart of ``fused_encode_async``).  The launcher
    takes the list as it is (each stripe at its own address and row
    stride); nothing is concatenated on the host."""
    dev = resolve_device(device)
    segs = [as_bytes_tensor(c, dev) for c in chunks_list]
    for s in segs:
        if s.dim() != 2:
            raise ValueError(f"each stripe must be [k, L], got {tuple(s.shape)}")
    return _apply(np.asarray(mat), segs, dev, mat_key)


class BitplaneCodec:
    """Encode/decode a systematic RS code through the GF apply seam.

    Mirrors the encode_chunks/decode_chunks split of the reference's
    ErasureCodeInterface (reference:
    src/erasure-code/ErasureCodeInterface.h :: encode_chunks, decode_chunks).
    """

    def __init__(self, coding: np.ndarray, device=None):
        self.device = resolve_device(device)
        self.coding = np.ascontiguousarray(coding, dtype=np.uint8)
        self.m, self.k = self.coding.shape
        self.coding_digest = matrix_digest(self.coding)
        self.generator = systematic_generator(self.coding)
        #: erasure pattern -> (decode matrix, its stable digest)
        self._decode_cache: dict[tuple[int, ...], tuple[np.ndarray, str]] = {}

    def encode(self, data) -> torch.Tensor:
        """[k, L] data shards -> [m, L] parity shards."""
        data = as_bytes_tensor(data, self.device)
        if data.dim() != 2 or data.shape[0] != self.k:
            raise ValueError(f"expected [{self.k}, L] data shards, got "
                             f"{tuple(data.shape)}")
        return apply_matrix(self.coding, data, self.device, self.coding_digest)

    def encode_many(self, stripes) -> torch.Tensor:
        """[k, L_s] stripes -> one [m, sum L_s] parity tensor, one launch."""
        return fused_encode(self.coding, stripes, self.device, self.coding_digest)

    def _decode_entry(self, available_rows) -> tuple[np.ndarray, str]:
        """Per-erasure-pattern inverted matrix and its digest, host-cached
        (the ISA-L table-cache pattern)."""
        key = tuple(available_rows[: self.k])
        ent = self._decode_cache.get(key)
        if ent is None:
            dm = decode_matrix_for(self.generator, self.k, list(key)).astype(np.uint8)
            ent = (dm, matrix_digest(dm))
            self._decode_cache[key] = ent
        return ent

    def decode(self, available_rows, shards) -> torch.Tensor:
        """Rebuild the k data shards from >= k surviving shards.

        available_rows: shard ids (sorted) matching shards' leading rows.
        """
        rows = tuple(int(r) for r in available_rows)
        if len(rows) < self.k:
            raise ValueError(f"need >= {self.k} shards, got {len(rows)}")
        dm, dm_key = self._decode_entry(rows)
        shards = as_bytes_tensor(shards, self.device)[: self.k]
        return apply_matrix(dm, shards, self.device, dm_key)

    def reconstruct(self, available_rows, shards, want_rows) -> torch.Tensor:
        """Rebuild arbitrary shards (data or parity) — the recovery path
        (reference: src/osd/ECBackend.cc :: recover_object re-encodes
        missing shards from decoded data)."""
        data = self.decode(available_rows, shards)
        want_rows = [int(w) for w in want_rows]
        out_mat = self.generator[want_rows, :].astype(np.uint8)
        return apply_matrix(out_mat, data, self.device)
