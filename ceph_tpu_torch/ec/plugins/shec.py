"""SHEC — Shingled Erasure Code plugin (k, m, c); counterpart of
ceph_tpu/ec/plugins/shec.py.  Encode and decode go through the port's
GF apply seam (ops/bitplane.apply_matrix).

Reference: src/erasure-code/shec/ErasureCodeShec.{h,cc} + ShecTableCache —
local parity groups arranged as overlapping "shingles" over the data chunks,
so a single-chunk failure is repaired by reading ~k*c/m chunks instead of k
(SURVEY.md §2.1).  m parities each cover a cyclic window of
ceil(k*c/m) data chunks starting at floor(i*k/m); coefficients inside a
window come from the Cauchy construction (1/(i ^ (m+j))) so overlapping
groups stay independent.

Provenance caveat (SURVEY.md §0): the reference mount was empty, so this
implements the construction from the published SHEC design (Miyamae et al.,
and the reference's documented profile semantics); parity bytes are NOT
claimed byte-identical to the reference plugin's — the *recovery semantics*
(minimum_to_decode search over shingles, c-erasure durability, recovery
efficiency) are what tests pin down.

The decode path solves the windowed linear system over GF(2^8) directly
(gf_solve) and caches the recovery plan per erasure pattern, the role of
ErasureCodeShecTableCache.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ...common.device import as_bytes_tensor

from ...gf.matrix import gf_rank, gf_solve
from ...gf.tables import gf_inv
from ..interface import ErasureCode, InsufficientChunks, InvalidProfile
from ..registry import ErasureCodePlugin


def shec_coding_matrix(k: int, m: int, c: int) -> np.ndarray:
    """m x k matrix with cyclic shingled windows of width ceil(k*c/m)."""
    width = -(-k * c // m)  # ceil(k*c/m)
    mat = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        start = (i * k) // m
        for off in range(width):
            j = (start + off) % k
            mat[i, j] = gf_inv(i ^ (m + j))
    return mat


class ShecCodec(ErasureCode):
    def __init__(self, profile: dict | None = None, device=None):
        self._plan_cache: dict[tuple, tuple] = {}
        self._dm_cache: dict[tuple, np.ndarray] = {}
        super().__init__(profile, device)

    def init(self, profile: dict) -> None:
        self.profile = dict(profile)
        self.k = self.parse_int(profile, "k", 4)
        self.m = self.parse_int(profile, "m", 3)
        self.c = self.parse_int(profile, "c", 2)
        if not (1 <= self.c <= self.m <= self.k):
            raise InvalidProfile(
                f"SHEC requires 1 <= c <= m <= k, got k={self.k} m={self.m} c={self.c}"
            )
        if self.k + self.m > 255:
            raise InvalidProfile("k+m must be <= 255")
        self.set_coding(shec_coding_matrix(self.k, self.m, self.c))
        self.window = -(-self.k * self.c // self.m)

    def set_coding(self, coding) -> None:
        """Install the coding matrix (built here, or carried in by
        ec/state.codec_from_arrays); drops the plans cached for the old one."""
        self._plan_cache.clear()
        self._dm_cache.clear()
        self.coding = self.checked_coding(coding).astype(np.int64)

    # -- encode -----------------------------------------------------------
    def supports_parity_delta(self) -> bool:
        return True  # byte-matrix apply, column-local, identity layout

    def encode_chunks(self, data_chunks) -> torch.Tensor:
        from ...ops.bitplane import apply_matrix

        return apply_matrix(self.coding.astype(np.uint8), data_chunks, self.device)

    # -- recovery plan search (ErasureCodeShec::minimum_to_decode role) ---
    def _window(self, p: int) -> set[int]:
        return {int(j) for j in np.nonzero(self.coding[p])[0]}

    def _requirements(
        self, want: frozenset[int], available: frozenset[int]
    ) -> tuple[list[int], set[int]]:
        """(data chunks that must be solved for, available window data that
        wanted-parity re-encode additionally reads)."""
        avail_data = {a for a in available if a < self.k}
        want_data_missing = {w for w in want if w < self.k} - available
        want_parity_missing = {
            w - self.k for w in want if w >= self.k and w not in available
        }
        parity_window: set[int] = set()
        for p in want_parity_missing:
            parity_window |= self._window(p)
        solve_targets = sorted(want_data_missing | (parity_window - avail_data))
        return solve_targets, parity_window & avail_data

    def _recovery_plan(
        self, want: frozenset[int], available: frozenset[int]
    ) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """Minimal read set: smallest parity subset whose windows cover the
        solve targets with available data and whose coefficient submatrix has
        full rank, plus the window data wanted parities re-encode from."""
        key = (want, available)
        if key in self._plan_cache:
            return self._plan_cache[key]
        solve_targets, parity_read = self._requirements(want, available)
        avail_parities = sorted(a - self.k for a in available if a >= self.k)
        avail_data = {a for a in available if a < self.k}
        if not solve_targets:
            plan = (tuple(sorted(parity_read)), ())
            self._plan_cache[key] = plan
            return plan
        targets = set(solve_targets)
        for n_par in range(len(solve_targets), len(avail_parities) + 1):
            best: tuple | None = None
            for parities in itertools.combinations(avail_parities, n_par):
                cols: set[int] = set()
                for p in parities:
                    cols |= self._window(p)
                if (cols - targets) - avail_data:
                    continue  # a window needs data that is neither available
                    # nor being solved for
                A = np.stack([self.coding[p, solve_targets] for p in parities])
                if gf_rank(A) < len(solve_targets):
                    continue
                read_data = ((cols - targets) & avail_data) | parity_read
                cost = len(read_data) + n_par
                if best is None or cost < best[0]:
                    best = (cost, tuple(sorted(read_data)), tuple(parities))
            if best is not None:
                plan = (best[1], best[2])
                self._plan_cache[key] = plan
                return plan
        raise InsufficientChunks(
            f"SHEC cannot recover {sorted(want)} from {sorted(available)}"
        )

    def minimum_to_decode(self, want_to_read, available):
        want = frozenset(want_to_read)
        avail = frozenset(available)
        if want <= avail:
            return {c: [(0, -1)] for c in sorted(want)}
        read_data, parities = self._recovery_plan(want, avail)
        chunks = set(read_data) | {self.k + p for p in parities}
        chunks |= want & avail
        return {c: [(0, -1)] for c in sorted(chunks)}

    def _decode_matrix(
        self, want: frozenset[int], avail_t: tuple[int, ...]
    ) -> np.ndarray:
        """[n_want, n_avail] GF(2^8) matrix M with wanted = M @ available.

        The whole SHEC recovery — windowed solve plus parity re-encode —
        is GF-linear in the available chunks, so it collapses to ONE
        cached matrix applied on-device (the ShecTableCache role,
        reference: shec/ErasureCodeShecTableCache.cc, upgraded from
        decode-matrix caching to whole-plan caching)."""
        key = (want, avail_t)
        cached = self._dm_cache.get(key)
        if cached is not None:
            return cached
        from ...gf.tables import GF_MUL_TABLE

        avail = frozenset(avail_t)
        solve_targets, _ = self._requirements(want, avail)
        _, parities = self._recovery_plan(want, avail)
        n_in = len(avail_t)
        pos = {c: i for i, c in enumerate(avail_t)}
        rowX: dict[int, np.ndarray] = {}
        if solve_targets:
            # express each windowed-parity equation's RHS as a coefficient
            # row over the available chunks, then solve for the targets
            A = np.stack([self.coding[p, solve_targets] for p in parities])
            Bcoef = np.zeros((len(parities), n_in), dtype=np.int64)
            for r, p in enumerate(parities):
                Bcoef[r, pos[self.k + p]] ^= 1
                for j in self._window(p):
                    if j in solve_targets:
                        continue
                    Bcoef[r, pos[j]] ^= int(self.coding[p, j])
            X = gf_solve(A, Bcoef)  # [n_targets, n_in]
            for idx, j in enumerate(solve_targets):
                rowX[j] = X[idx].astype(np.int64)

        def data_row(j: int) -> np.ndarray:
            if j in rowX:
                return rowX[j]
            e = np.zeros(n_in, dtype=np.int64)
            e[pos[j]] = 1
            return e

        rows = []
        for w in sorted(want):
            if w in pos:
                e = np.zeros(n_in, dtype=np.int64)
                e[pos[w]] = 1
                rows.append(e)
            elif w < self.k:
                rows.append(data_row(w))
            else:
                p = w - self.k
                r = np.zeros(n_in, dtype=np.int64)
                for j in self._window(p):
                    c = int(self.coding[p, j])
                    r ^= GF_MUL_TABLE[c, data_row(j)]
                rows.append(r)
        M = np.stack(rows).astype(np.uint8)
        self._dm_cache[key] = M
        return M

    def decode_chunks(self, want_to_read, chunks):
        from ...ops.bitplane import apply_matrix

        want = frozenset(want_to_read)
        avail_t = tuple(sorted(chunks))
        M = self._decode_matrix(want, avail_t)
        stacked = torch.stack(
            [as_bytes_tensor(chunks[c], self.device) for c in avail_t]
        )
        out = apply_matrix(M, stacked, self.device)
        return {w: out[i] for i, w in enumerate(sorted(want))}


class ShecPlugin(ErasureCodePlugin):
    """reference: shec/ErasureCodePluginShec.cc."""

    def factory(self, profile: dict, device=None) -> ShecCodec:
        return ShecCodec(profile, device)
