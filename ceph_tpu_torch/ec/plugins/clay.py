"""CLAY — coupled-layer MSR regenerating code plugin (k, m, d); counterpart
of ceph_tpu/ec/plugins/clay.py.  The coupling runs as tensor ops on the
codec's device; every per-plane MDS decode and the single-shard repair go
through the port's GF apply seam (ops/bitplane.apply_matrix).

Reference: src/erasure-code/clay/ErasureCodeClay.{h,cc} — repair of a single
lost chunk reads only sub-chunks from d helper chunks (bandwidth-optimal MSR
point), introducing get_sub_chunk_count() and sub-chunk-range
minimum_to_decode into the codec interface (SURVEY.md §2.1).

Construction (Clay codes, FAST'18, as the reference implements):
- q = d - k + 1, t = (k+m)/q; node (x, y) for x in [0,q), y in [0,t);
  chunk index n = y*q + x; data nodes are n < k.
- Each chunk holds q^t sub-chunks, one per "plane" z, whose base-q digits
  are (z_0..z_{t-1}) (y=0 least significant here).
- Uncoupled symbols U(x,y;z) form, per plane, a codeword of the scalar MDS
  code [I_k; C] (the same jerasure-exact RS generator as the rs plugin).
- Coupling: for x != z_y, the pair P1=(x,y;z), P2=(z_y,y;z') with
  z' = z(y -> x) satisfies C1 = U1 ^ g*U2 and C2 = g*U1 ^ U2 (g = 2;
  det 1^g^2 = (1+g)^2 != 0); for x == z_y ("vertex"), C = U.
- Encode and multi-erasure decode run the layered algorithm: planes in
  increasing intersection-score order, U recovered via pair inversion or
  earlier planes, per-plane MDS decode of erased U, then C of erased nodes
  from U pairs.
- Single-chunk repair with d = k+m-1 (the reference's default d) reads only
  the q^(t-1) planes with z_{y0} = x0 from every survivor — bandwidth
  d/(k*q) of naive (BASELINE.json config 4 measures exactly this).

Scope notes vs the reference: d must satisfy q | (k+m) (the reference pads
with shortened virtual nodes otherwise); bandwidth-optimal repair is
implemented for d = k+m-1 with all survivors as helpers, and falls back to
full decode for other cases.  Parity bytes are internally defined (empty
reference mount, SURVEY.md §0); sub-chunk accounting and repair-bandwidth
semantics are what tests pin.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...common.device import as_bytes_tensor
from ...gf.matrix import decode_matrix_for, systematic_generator, vandermonde_coding_matrix

from ...gf.tables import GF_MUL_TABLE, gf_inv
from ..interface import ErasureCode, InsufficientChunks, InvalidProfile
from ..registry import ErasureCodePlugin

GAMMA = 2
_INV_DET = gf_inv(1 ^ GF_MUL_TABLE[GAMMA, GAMMA])  # 1/(1 + g^2)
_INV_G = gf_inv(GAMMA)


def _gmul(c: int, arr: np.ndarray) -> np.ndarray:
    """c * arr in GF(2^8) on host arrays (the repair-matrix build)."""
    return GF_MUL_TABLE[c, arr]


@lru_cache(maxsize=64)
def _mul_row(c: int, device: str) -> torch.Tensor:
    return torch.from_numpy(GF_MUL_TABLE[c].copy()).to(device)


def _tmul(c: int, arr: torch.Tensor) -> torch.Tensor:
    """c * arr in GF(2^8), bytewise, on arr's device."""
    return _mul_row(c, str(arr.device))[arr.long()]


class ClayCodec(ErasureCode):
    def __init__(self, profile: dict | None = None, device=None):
        #: (lost, helpers) -> (repair matrix, stable digest)
        self._repair_mat_cache: dict[tuple, tuple[np.ndarray, str]] = {}
        super().__init__(profile, device)

    def init(self, profile: dict) -> None:
        self.profile = dict(profile)
        self.k = self.parse_int(profile, "k", 4)
        self.m = self.parse_int(profile, "m", 2)
        self.d = self.parse_int(profile, "d", self.k + self.m - 1)
        if not (self.k <= self.d <= self.k + self.m - 1):
            raise InvalidProfile(
                f"CLAY requires k <= d <= k+m-1, got k={self.k} m={self.m} d={self.d}"
            )
        self.q = self.d - self.k + 1
        n = self.k + self.m
        if n % self.q:
            raise InvalidProfile(
                f"(k+m)={n} must be divisible by q=d-k+1={self.q} "
                "(the reference pads with shortened nodes; unsupported here)"
            )
        self.t = n // self.q
        self.sub_chunk_count = self.q**self.t
        self.set_coding(vandermonde_coding_matrix(self.k, self.m))

    def set_coding(self, coding) -> None:
        """Install the scalar MDS coding matrix (built here, or carried in
        by ec/state.codec_from_arrays); drops repair matrices built from
        the old one."""
        self._repair_mat_cache.clear()
        coding = self.checked_coding(coding)
        self.generator = systematic_generator(coding)
        self.coding = coding.astype(np.uint8)

    def set_repair_matrix(self, lost: int, helpers: tuple[int, ...],
                          M: np.ndarray) -> None:
        """Install a repair matrix built elsewhere for (lost, helpers)."""
        from ...ops.bitplane import matrix_digest

        helpers = tuple(int(h) for h in helpers)
        M = np.ascontiguousarray(M, dtype=np.uint8)
        want = (self.sub_chunk_count,
                len(helpers) * len(self.repair_planes(lost)))
        if M.shape != want:
            raise InvalidProfile(f"repair matrix {M.shape}, want {want}")
        self._repair_mat_cache[(int(lost), helpers)] = (M, matrix_digest(M))

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_count

    def get_chunk_size(self, stripe_width: int) -> int:
        base = super().get_chunk_size(stripe_width)
        # chunk must split into q^t sub-chunks of CHUNK_ALIGN-friendly size
        unit = self.sub_chunk_count
        return -(-base // unit) * unit

    # -- geometry ---------------------------------------------------------
    def _node(self, n: int) -> tuple[int, int]:
        return n % self.q, n // self.q

    def _digit(self, z: int, y: int) -> int:
        return (z // self.q**y) % self.q

    def _replace(self, z: int, y: int, x: int) -> int:
        p = self.q**y
        return z - self._digit(z, y) * p + x * p

    # -- layered decode (ErasureCodeClay::decode_layered) -----------------
    def _layered_decode(
        self, C: dict[int, torch.Tensor], erased: list[int], sub_len: int
    ) -> dict[int, torch.Tensor]:
        """C: node -> [Z, sub_len] known coupled chunks; returns C for erased.

        Restructuring of ErasureCodeClay::decode_layered: planes are
        grouped by intersection score (all cross-plane dependencies point
        at strictly lower scores), couplings are tensor ops over each group
        on the codec's device, and the per-plane MDS decodes collapse into
        ONE GF apply per score group instead of Z small ones."""
        from ...ops.bitplane import apply_matrix, matrix_digest

        nq, t, Z = self.q, self.t, self.sub_chunk_count
        n_nodes = self.k + self.m
        dev = self.device
        erased_set = set(erased)
        if len(erased_set) > self.m:
            raise InsufficientChunks(f"{len(erased_set)} erasures > m={self.m}")
        U = torch.zeros((n_nodes, Z, sub_len), dtype=torch.uint8, device=dev)
        Cd = torch.zeros((n_nodes, Z, sub_len), dtype=torch.uint8, device=dev)
        for node, v in C.items():
            Cd[node] = v
        erased_t = torch.tensor(sorted(erased_set), dtype=torch.int64, device=dev)
        zs_all = torch.arange(Z, device=dev)
        digits = torch.stack(
            [(zs_all // nq**y) % nq for y in range(t)]
        )  # [t, Z]
        scores = torch.zeros(Z, dtype=torch.int64, device=dev)
        for y in range(t):
            scores += torch.isin(y * nq + digits[y], erased_t)
        avail_nodes = sorted(set(range(n_nodes)) - erased_set)
        dm = decode_matrix_for(self.generator, self.k, avail_nodes).astype(np.uint8)
        dm_key = matrix_digest(dm)
        parity_erased = bool(erased_set & set(range(self.k, n_nodes)))
        for s in range(int(scores.max()) + 1):
            zs = zs_all[scores == s]
            if zs.numel() == 0:
                continue
            # uncoupled U for available nodes, vectorized over the group
            for node in avail_nodes:
                x, y = self._node(node)
                digs = digits[y, zs]                      # [nZ]
                pnode = y * nq + digs
                zp = zs + (x - digs) * nq**y
                vertex = (digs == x)[:, None]
                partner_ok = (~torch.isin(pnode, erased_t))[:, None]
                c1 = Cd[node, zs]
                c2 = Cd[pnode, zp]
                u_pair = _tmul(_INV_DET, c1 ^ _tmul(GAMMA, c2))
                u_part = c1 ^ _tmul(GAMMA, U[pnode, zp])  # zp has score s-1
                U[node, zs] = torch.where(
                    vertex, c1, torch.where(partner_ok, u_pair, u_part)
                )
            # one batched MDS decode for every plane in the group
            sub = U[avail_nodes[: self.k]][:, zs].reshape(self.k, -1)
            data_u = apply_matrix(dm, sub, dev, dm_key)
            full = torch.zeros((n_nodes, zs.numel() * sub_len), dtype=torch.uint8,
                               device=dev)
            full[: self.k] = data_u
            if parity_erased:
                full[self.k :] = apply_matrix(self.coding, data_u, dev)
            for node in erased_set:
                U[node, zs] = full[node].reshape(zs.numel(), sub_len)
        # rebuild coupled C for erased nodes from the complete U
        out: dict[int, torch.Tensor] = {}
        for node in erased:
            x, y = self._node(node)
            digs = digits[y]
            pnode = y * nq + digs
            zp = zs_all + (x - digs) * nq**y
            vertex = (digs == x)[:, None]
            out[node] = torch.where(
                vertex, U[node], U[node] ^ _tmul(GAMMA, U[pnode, zp])
            )
        return out

    # -- interface --------------------------------------------------------
    def encode_chunks(self, data_chunks) -> torch.Tensor:
        data_chunks = as_bytes_tensor(data_chunks, self.device)
        k, L = data_chunks.shape
        if k != self.k:
            raise ValueError(f"expected {self.k} data chunks, got {k}")
        Z = self.sub_chunk_count
        if L % Z:
            raise ValueError(f"chunk length {L} not divisible by {Z} sub-chunks")
        sub_len = L // Z
        C = {i: data_chunks[i].reshape(Z, sub_len) for i in range(self.k)}
        parity = self._layered_decode(
            C, list(range(self.k, self.k + self.m)), sub_len
        )
        return torch.stack(
            [parity[self.k + i].reshape(L) for i in range(self.m)]
        )

    def decode_chunks(self, want_to_read, chunks):
        have = {int(i): as_bytes_tensor(v, self.device).reshape(-1)
                for i, v in chunks.items()}
        L = next(iter(have.values())).numel()
        Z = self.sub_chunk_count
        sub_len = L // Z
        erased = sorted(set(range(self.k + self.m)) - set(have))
        lost_wanted = sorted(set(want_to_read) - set(have))
        if not lost_wanted:
            return {w: have[w] for w in want_to_read}
        if len(erased) == 1 and self.d == self.k + self.m - 1 and len(have) >= self.d:
            rebuilt = self._repair_one(have, erased[0], sub_len)
            out = {erased[0]: rebuilt}
        else:
            C = {i: v.reshape(Z, sub_len) for i, v in have.items()}
            dec = self._layered_decode(C, erased, sub_len)
            out = {n: v.reshape(Z * sub_len) for n, v in dec.items()}
        result = {}
        for w in set(want_to_read):
            result[w] = have[w] if w in have else out[w]
        return result

    # -- bandwidth-optimal single repair (d = k+m-1) ----------------------
    def repair_planes(self, lost: int) -> list[int]:
        """Planes read during repair of `lost`: z with z_{y0} == x0."""
        x0, y0 = self._node(lost)
        return [
            z for z in range(self.sub_chunk_count) if self._digit(z, y0) == x0
        ]

    def repair_subchunk_ranges(self, lost: int) -> list[tuple[int, int]]:
        """Contiguous (offset, count) runs of sub-chunk indices helpers read
        (the shape minimum_to_decode reports, reference:
        ErasureCodeClay::minimum_to_decode sub-chunk ranges)."""
        planes = self.repair_planes(lost)
        runs: list[tuple[int, int]] = []
        for z in planes:
            if runs and runs[-1][0] + runs[-1][1] == z:
                runs[-1] = (runs[-1][0], runs[-1][1] + 1)
            else:
                runs.append((z, 1))
        return runs

    def minimum_to_decode(self, want_to_read, available):
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return {c: [(0, -1)] for c in sorted(want)}
        missing = want - avail
        if (
            len(missing) == 1
            and self.d == self.k + self.m - 1
            and len(avail) >= self.d
        ):
            ranges = self.repair_subchunk_ranges(next(iter(missing)))
            plan = {c: list(ranges) for c in sorted(avail)[: self.d]}
            # wanted-and-available chunks are read in full, not just the
            # repair planes a helper contributes (reference: Clay's
            # minimum_to_decode merges want_to_read into the helper set)
            for c in want & avail:
                plan[c] = [(0, -1)]
            return plan
        if len(avail) < self.k:
            raise InsufficientChunks(f"need {self.k} chunks, have {len(avail)}")
        return {c: [(0, -1)] for c in sorted(avail)[: self.k]}

    def repair_matrix(self, lost: int, helpers: tuple[int, ...]) -> np.ndarray:
        """[Z, len(helpers)*nB] GF(2^8) matrix M with
        ``lost_subchunks = M @ fetched``, where `fetched` stacks each
        helper's repair-plane sub-chunk rows in helper order.

        The ENTIRE single-shard repair — pair uncoupling, per-plane MDS
        decode, parity re-encode, recoupling — is GF-linear in the fetched
        bytes, so it collapses into one cached matrix and repair becomes a
        single GF apply on the device.  (Restructure of
        ErasureCodeClay::repair's layered host loop; the algebra below IS
        the layered algorithm, run symbolically on coefficient rows
        instead of chunk bytes.)"""
        return self.repair_matrix_entry(lost, helpers)[0]

    def repair_matrix_entry(self, lost: int,
                            helpers: tuple[int, ...]) -> tuple:
        """(repair matrix, its stable digest): the digest is computed once
        at cache fill and keys the device table cache."""
        key = (lost, helpers)
        cached = self._repair_mat_cache.get(key)
        if cached is not None:
            return cached
        M = self._build_repair_matrix(lost, helpers)
        from ...ops.bitplane import matrix_digest

        ent = (M, matrix_digest(M))
        self._repair_mat_cache[key] = ent
        return ent

    def _build_repair_matrix(self, lost: int,
                             helpers: tuple[int, ...]) -> np.ndarray:
        from ...gf.reference_codec import apply_matrix as gf_apply

        nq, Z = self.q, self.sub_chunk_count
        n_nodes = self.k + self.m
        x0, y0 = self._node(lost)
        planes = np.asarray(self.repair_planes(lost))
        nB = planes.size
        plane_pos = np.full(Z, -1, dtype=np.int64)
        plane_pos[planes] = np.arange(nB)
        n_in = len(helpers) * nB
        # coefficient rows: Cb[node, b] = unit vector of input position
        # (helper node, repair plane b)
        Cb = np.zeros((n_nodes, nB, n_in), dtype=np.uint8)
        for hi, node in enumerate(helpers):
            Cb[node, np.arange(nB), hi * nB + np.arange(nB)] = 1
        U = np.zeros((n_nodes, nB, n_in), dtype=np.uint8)
        known_u_nodes = []
        for node in helpers:
            x, y = self._node(node)
            if y == y0:
                continue  # column y0 survivors: U unknown in B planes
            known_u_nodes.append(node)
            digs = (planes // nq**y) % nq                  # [nB]
            pnode = y * nq + digs
            zp = planes + (x - digs) * nq**y               # stays in B
            vertex = (digs == x)[:, None]
            c1 = Cb[node]
            c2 = Cb[pnode, plane_pos[zp]]
            U[node] = np.where(
                vertex, c1, _gmul(_INV_DET, c1 ^ _gmul(GAMMA, c2))
            )
        # batched MDS decode: unknown U's are exactly column y0 (q nodes);
        # survivors outside column y0 must supply at least k known U's
        unknown = [y0 * nq + x for x in range(nq)]
        if len(known_u_nodes) < self.k:
            raise InsufficientChunks(
                f"repair needs {self.k} helpers outside column {y0}, "
                f"have {len(known_u_nodes)}"
            )
        dm = decode_matrix_for(
            self.generator, self.k, known_u_nodes
        ).astype(np.uint8)
        sub = U[known_u_nodes[: self.k]].reshape(self.k, -1)
        data_u = gf_apply(dm, sub)
        full = np.zeros((n_nodes, nB * n_in), dtype=np.uint8)
        full[: self.k] = data_u
        full[self.k :] = gf_apply(self.coding, data_u)
        for node in unknown:
            U[node] = full[node].reshape(nB, n_in)
        # rebuild lost chunk: B-planes are vertex (C = U); others via pairs
        zs_all = np.arange(Z)
        dy0 = (zs_all // nq**y0) % nq
        pnode = y0 * nq + dy0                              # [Z]
        zp = zs_all + (x0 - dy0) * nq**y0                  # in B
        zpi = plane_pos[zp]
        u2 = U[pnode, zpi]                                 # [Z, n_in]
        # C2 = g*U1 ^ U2 with P1=(lost;z), P2=(pnode;zp):
        u1 = _gmul(_INV_G, Cb[pnode, zpi] ^ u2)
        M = np.where(
            (dy0 == x0)[:, None], U[lost, zpi], u1 ^ _gmul(GAMMA, u2)
        )
        return M

    def gather_repair_input(
        self, have: dict[int, torch.Tensor], lost: int, sub_len: int,
        helpers: tuple[int, ...],
    ) -> torch.Tensor:
        """[len(helpers)*nB, sub_len] — each helper's repair-plane
        sub-chunks stacked in helper order (the layout repair_matrix
        contracts over)."""
        Z = self.sub_chunk_count
        planes = torch.tensor(self.repair_planes(lost), device=self.device)
        return torch.cat(
            [have[n].reshape(Z, sub_len)[planes] for n in helpers]
        )

    def _repair_one(
        self, have: dict[int, torch.Tensor], lost: int, sub_len: int
    ) -> torch.Tensor:
        """Rebuild `lost` reading only the repair planes from all
        survivors: one cached-matrix device apply."""
        from ...ops.bitplane import apply_matrix

        helpers = tuple(sorted(have))
        M, m_key = self.repair_matrix_entry(lost, helpers)
        x = self.gather_repair_input(have, lost, sub_len, helpers)
        out = apply_matrix(M, x, self.device, m_key)
        return out.reshape(self.sub_chunk_count * sub_len)


class ClayPlugin(ErasureCodePlugin):
    """reference: clay/ErasureCodePluginClay.cc."""

    def factory(self, profile: dict, device=None) -> ClayCodec:
        return ClayCodec(profile, device)
