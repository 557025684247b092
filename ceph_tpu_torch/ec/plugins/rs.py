"""Reed-Solomon plugin family — counterpart of ceph_tpu/ec/plugins/rs.py.

Covers the matrix techniques of the reference's jerasure plugin (reference:
src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc}) and the ISA-L plugin
(reference: src/erasure-code/isa/ErasureCodeIsa.{h,cc}):

    reed_sol_van    ErasureCodeJerasureReedSolomonVandermonde
    reed_sol_r6_op  ErasureCodeJerasureReedSolomonRAID6 (m=2: rows 1, 2^j)
    cauchy_orig     ErasureCodeJerasureCauchyOrig
    cauchy_good     ErasureCodeJerasureCauchyGood

The bitmatrix/packet techniques (liberation, blaum_roth, liber8tion) are
not ported yet; a profile naming one is rejected.

Two backends execute the same matrices, with identical bytes:
    torch   the CUDA GF apply (ops/bitplane.py), or its plain version on cpu
    numpy   pure-numpy referee (gf/reference_codec.py)
"""
from __future__ import annotations

import numpy as np
import torch

from ...common.device import as_bytes_tensor
from ...gf.matrix import (
    cauchy_good_coding_matrix,
    cauchy_original_coding_matrix,
    vandermonde_coding_matrix,
)
from ...gf.tables import gf_pow
from ..interface import ErasureCode, InsufficientChunks, InvalidProfile
from ..registry import ErasureCodePlugin

TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good")
#: the jerasure packet techniques, still to be ported (gf/gf2.py and
#: BitmatrixCodec of the reference)
BITMATRIX_TECHNIQUES = ("liberation", "blaum_roth", "liber8tion")


def build_coding_matrix(technique: str, k: int, m: int) -> np.ndarray:
    if technique == "reed_sol_van":
        return vandermonde_coding_matrix(k, m).astype(np.uint8)
    if technique == "reed_sol_r6_op":
        # reed_sol.c :: reed_sol_r6_coding_matrix — RAID-6: row0 all ones,
        # row1[j] = 2^j
        if m != 2:
            raise InvalidProfile("technique=reed_sol_r6_op requires m=2")
        mat = np.ones((2, k), dtype=np.uint8)
        mat[1] = [gf_pow(2, j) for j in range(k)]
        return mat
    if technique == "cauchy_orig":
        return cauchy_original_coding_matrix(k, m).astype(np.uint8)
    if technique == "cauchy_good":
        return cauchy_good_coding_matrix(k, m).astype(np.uint8)
    if technique in BITMATRIX_TECHNIQUES:
        raise InvalidProfile(f"technique={technique} is not ported yet")
    raise InvalidProfile(
        f"unknown technique {technique!r}; known: {TECHNIQUES}"
    )


class RSCodec(ErasureCode):
    """Systematic MDS Reed-Solomon codec over GF(2^8)."""

    def __init__(self, profile: dict | None = None, backend: str = "torch",
                 device=None):
        self.backend = backend
        self.bitplane = None
        super().__init__(profile, device="cpu" if backend == "numpy" else device)

    def init(self, profile: dict) -> None:
        self.profile = dict(profile)
        self.k = self.parse_int(profile, "k", 2)
        self.m = self.parse_int(profile, "m", 1)
        self.technique = profile.get("technique", "reed_sol_van")
        w = self.parse_int(profile, "w", 8)
        if w != 8:
            raise InvalidProfile(
                f"w={w} unsupported: the GF kernels are specialized for "
                "GF(2^8) (w=8), the default in the reference too"
            )
        if self.k < 1 or self.m < 1:
            raise InvalidProfile(f"k={self.k}, m={self.m} must be >= 1")
        self.set_coding(build_coding_matrix(self.technique, self.k, self.m))

    def set_coding(self, coding) -> None:
        """Install the coding matrix (built here, or carried in by
        ec/state.codec_from_arrays)."""
        from ...ops.bitplane import BitplaneCodec

        self.coding = self.checked_coding(coding).astype(np.uint8)
        if self.backend == "torch":
            self.bitplane = BitplaneCodec(self.coding, self.device)

    # -- hot path (reference: ErasureCodeInterface.h :: encode_chunks) ----
    def supports_parity_delta(self) -> bool:
        # byte-wise GF matrix apply: strictly column-local, identity
        # placement — safe for the OSD's RMW parity-delta
        return True

    def encode_chunks(self, data_chunks) -> torch.Tensor:
        data = as_bytes_tensor(data_chunks, self.device)
        if self.backend == "torch":
            return self.bitplane.encode(data)
        from ...gf.reference_codec import encode_chunks as np_encode

        return torch.from_numpy(np_encode(self.coding, data.numpy()))

    def decode_chunks(self, want_to_read, chunks):
        avail = sorted(chunks)
        if len(avail) < self.k:
            raise InsufficientChunks(f"need {self.k}, have {len(avail)}")
        use = avail[: self.k]
        shards = torch.stack([as_bytes_tensor(chunks[r], self.device) for r in use])
        if self.backend == "torch":
            data = self.bitplane.decode(use, shards)
        else:
            from ...gf.reference_codec import decode_chunks as np_decode

            out = np_decode(self.coding, self.k,
                            dict(zip(use, shards.numpy())), want=list(range(self.k)))
            data = torch.from_numpy(np.stack([out[i] for i in range(self.k)]))
        result: dict[int, torch.Tensor] = {}
        missing_par = [
            w for w in sorted(set(want_to_read))
            if w >= self.k and w not in chunks
        ]
        if missing_par:
            # one batched apply for every missing parity row
            rowmat = np.ascontiguousarray(
                self.coding[[w - self.k for w in missing_par]]
            )
            if self.backend == "torch":
                from ...ops.bitplane import apply_matrix

                par = apply_matrix(rowmat, data, self.device)
            else:
                from ...gf.reference_codec import apply_matrix as np_apply

                par = torch.from_numpy(np_apply(rowmat, data.numpy()))
            for i, w in enumerate(missing_par):
                result[w] = par[i]
        for wanted in sorted(set(want_to_read)):
            if wanted in chunks:
                result[wanted] = as_bytes_tensor(chunks[wanted], self.device)
            elif wanted < self.k:
                result[wanted] = data[wanted]
        return result


class RSPlugin(ErasureCodePlugin):
    """Registry factory (reference: jerasure/ErasureCodePluginJerasure.cc ::
    ErasureCodePluginJerasure::factory switching on technique).  The
    numpy referee always runs on the host."""

    def __init__(self, backend: str = "torch"):
        self.backend = backend

    def factory(self, profile: dict, device=None):
        return RSCodec(profile, backend=self.backend, device=device)
