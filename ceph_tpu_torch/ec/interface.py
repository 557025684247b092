"""ErasureCodeInterface + ErasureCode base — the codec contract.

The port's counterpart of ceph_tpu/ec/interface.py, a re-design of the reference's codec interface and shared base class
(reference: src/erasure-code/ErasureCodeInterface.h :: ErasureCodeInterface —
init/get_chunk_count/get_chunk_size/minimum_to_decode/encode/decode/
decode_concat — and src/erasure-code/ErasureCode.{h,cc} :: ErasureCode, which
gives all plugins the shared chunk padding (encode_prepare), the default
first-k minimum_to_decode, and decode_concat).

Differences from the reference, by design:
- Chunks come in as uint8 torch tensors, numpy arrays or bytes instead of
  ceph::buffer::list, and come out as uint8 tensors on the codec's
  device (``cuda`` unless the codec was made with ``device="cpu"``).
- Chunk ids are plain ints 0..k+m-1 (shard ids).
- Sub-chunks (CLAY) are expressed exactly as the reference's
  get_sub_chunk_count() / minimum_to_decode sub-chunk ranges.
"""
from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from ..common.device import as_bytes_tensor, resolve_device


class ErasureCodeInterface(ABC):
    """Pure-virtual contract (reference: ErasureCodeInterface.h)."""

    @abstractmethod
    def init(self, profile: dict) -> None: ...

    @abstractmethod
    def get_chunk_count(self) -> int: ...

    @abstractmethod
    def get_data_chunk_count(self) -> int: ...

    def get_sub_chunk_count(self) -> int:
        """1 for MDS codes; >1 for CLAY (reference: ErasureCodeInterface.h ::
        get_sub_chunk_count, introduced for the CLAY plugin)."""
        return 1

    @abstractmethod
    def get_chunk_size(self, stripe_width: int) -> int: ...

    @abstractmethod
    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> dict[int, list[tuple[int, int]]]:
        """Map chunk -> list of (offset, length) sub-chunk ranges to fetch.

        MDS codes return the full chunk range; CLAY returns sub-chunk ranges
        (reference: ErasureCodeInterface.h :: minimum_to_decode; SHEC/CLAY
        make this nontrivial, SURVEY.md §3.2)."""

    @abstractmethod
    def encode(self, want_to_encode: set[int], data: bytes) -> dict[int, torch.Tensor]: ...

    @abstractmethod
    def encode_chunks(self, data_chunks) -> torch.Tensor: ...

    @abstractmethod
    def decode(
        self, want_to_read: set[int], chunks: dict, chunk_size: int
    ) -> dict[int, torch.Tensor]: ...

    def supports_parity_delta(self) -> bool:
        """True iff encode_chunks is BYTE-COLUMN-LOCAL and chunk
        placement is the identity split: parity byte at column c depends
        only on the k data bytes at column c.  That is exactly the
        property the OSD's partial-stripe RMW parity-delta relies on
        (delta window encode XORed into stored parity), and the one under
        which the write batcher fuses stripes of different ops.
        Sub-chunked codes (CLAY) return False — for them the OSD falls
        back to full-stripe re-encode."""
        return False

    def decode_concat(self, chunks: dict[int, np.ndarray]) -> bytes:
        """Reassemble the original byte stream from data chunks (reference:
        ErasureCode.cc :: decode_concat)."""
        k = self.get_data_chunk_count()
        chunk_size = len(next(iter(chunks.values())))
        decoded = self.decode(set(range(k)), chunks, chunk_size)
        return b"".join(decoded[i].cpu().numpy().tobytes() for i in range(k))


class ErasureCode(ErasureCodeInterface):
    """Shared plugin logic (reference: src/erasure-code/ErasureCode.cc).

    Subclasses set self.k / self.m in init() and implement encode_chunks /
    decode_chunks; everything else (padding, defaults) lives here.
    ``device`` is resolved once, here: ``cuda`` unless ``"cpu"`` is asked.
    """

    #: alignment quantum for chunk sizes; 64 keeps chunks aligned for
    #: both CPU SIMD tails and the GPU kernels' 4-byte words
    CHUNK_ALIGN = 64

    def __init__(self, profile: dict | None = None, device=None):
        self.device = resolve_device(device)
        self.k = 0
        self.m = 0
        self.profile: dict = {}
        if profile is not None:
            self.init(profile)

    # -- geometry ---------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_chunk_size(self, stripe_width: int) -> int:
        """ceil(stripe_width / k) aligned up (reference: per-plugin
        get_chunk_size, e.g. ErasureCodeJerasure.cc aligns to k*w*packetsize;
        here the alignment is CHUNK_ALIGN bytes)."""
        padded = -(-stripe_width // self.k)
        return -(-padded // self.CHUNK_ALIGN) * self.CHUNK_ALIGN

    # -- defaults ---------------------------------------------------------
    def minimum_to_decode(self, want_to_read, available):
        """Default MDS policy (reference: ErasureCode.cc ::
        _minimum_to_decode): wanted chunks that are present are read
        directly; otherwise the first k available chunks."""
        want_to_read = set(want_to_read)
        available = set(available)
        if want_to_read <= available:
            chosen = want_to_read
        else:
            if len(available) < self.k:
                raise InsufficientChunks(
                    f"need {self.k} chunks, only {len(available)} available"
                )
            chosen = set(sorted(available)[: self.k])
        return {c: [(0, -1)] for c in sorted(chosen)}

    def encode_prepare(self, data: bytes, chunk_size: int) -> np.ndarray:
        """Zero-pad to k*chunk_size and split into [k, chunk_size]
        (reference: ErasureCode.cc :: encode_prepare)."""
        buf = np.zeros(self.k * chunk_size, dtype=np.uint8)
        raw = np.frombuffer(data, dtype=np.uint8)
        if raw.size > buf.size:
            raise ValueError(f"object of {raw.size} B exceeds stripe of {buf.size} B")
        buf[: raw.size] = raw
        return buf.reshape(self.k, chunk_size)

    def encode(self, want_to_encode, data: bytes):
        chunk_size = self.get_chunk_size(len(data))
        chunks = as_bytes_tensor(self.encode_prepare(data, chunk_size), self.device)
        parity = self.encode_chunks(chunks)
        all_chunks = {i: chunks[i] for i in range(self.k)}
        all_chunks.update({self.k + i: parity[i] for i in range(self.m)})
        return {i: all_chunks[i] for i in sorted(want_to_encode)}

    def decode(self, want_to_read, chunks, chunk_size):
        """Default decode via decode_chunks when anything wanted is missing
        (reference: ErasureCode.cc :: _decode)."""
        want_to_read = set(want_to_read)
        have = set(chunks)
        if want_to_read <= have:
            return {i: as_bytes_tensor(chunks[i], self.device) for i in want_to_read}
        # no k-of-n precondition here: locality codecs (SHEC/LRC/CLAY) can
        # decode from fewer than k chunks; each decode_chunks raises
        # InsufficientChunks itself when the set really is too small
        return self.decode_chunks(want_to_read, chunks)

    def decode_chunks(self, want_to_read, chunks):  # pragma: no cover - abstract
        raise NotImplementedError

    # -- profile helpers --------------------------------------------------
    def parse_int(self, profile: dict, key: str, default: int) -> int:
        v = profile.get(key, default)
        try:
            return int(v)
        except (TypeError, ValueError) as e:
            raise InvalidProfile(f"profile {key}={v!r} is not an integer") from e

    def checked_coding(self, coding) -> np.ndarray:
        """A coding matrix handed in from outside (ec/state.py), checked
        against this codec's geometry."""
        coding = np.asarray(coding)
        if coding.shape != (self.m, self.k):
            raise InvalidProfile(
                f"coding matrix {coding.shape} does not fit k={self.k}, m={self.m}")
        if coding.size and (coding.min() < 0 or coding.max() > 255):
            raise InvalidProfile("coding matrix entries must be bytes")
        return coding


class InvalidProfile(ValueError):
    """Profile rejected (the analog of OSDMonitor's profile validation
    failure, reference: src/mon/OSDMonitor.cc handling of
    `osd erasure-code-profile set`)."""


class InsufficientChunks(ValueError):
    """Fewer than k chunks available for decode."""
