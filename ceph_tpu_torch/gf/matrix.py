"""Reed-Solomon / Cauchy coding-matrix construction, jerasure-algorithm-exact.

The port's own copy of ceph_tpu/gf/matrix.py; tests hold the two
constructions byte-identical.

These reproduce the *algorithms* of the reference's bundled jerasure library
(reference: src/erasure-code/jerasure/jerasure/src/reed_sol.c and cauchy.c),
including the elementary row/column operations jerasure applies to make the
Vandermonde matrix systematic — NOT a textbook Vandermonde (SURVEY.md §2.1
"Bit-exactness target").  The C++ oracle in native/gf_oracle.cc implements the
same algorithms independently; tests cross-check the two for every (k, m) in
range.

Provenance caveat (SURVEY.md §0): these algorithms are written from the
documented jerasure constructions and verified Python<->C++; they were not
diffed against the upstream jerasure source.

Also here: element->bitmatrix expansion (reference:
src/erasure-code/jerasure/jerasure/src/jerasure.c :: jerasure_matrix_to_bitmatrix)
which is the formulation the plain PyTorch apply executes, and GF Gauss-Jordan
inversion for decode (reference: jerasure.c :: jerasure_invert_matrix).
"""
from __future__ import annotations

import numpy as np

from .tables import GF_MUL_TABLE, gf_div, gf_inv, gf_mul


def vandermonde_coding_matrix(k: int, m: int) -> np.ndarray:
    """m x k coding matrix, technique reed_sol_van.

    Mirrors reed_sol.c :: reed_sol_vandermonde_coding_matrix — builds the
    (k+m) x k "big" Vandermonde distribution matrix, converts the top k x k
    block to identity with elementary *column* operations, scales columns so
    the first coding row is all ones, and returns the bottom m rows.
    """
    rows, cols = k + m, k
    if rows >= 256:
        raise ValueError(f"k+m={rows} must be < 256 for w=8")
    dist = big_vandermonde_distribution_matrix(rows, cols)
    return dist[cols:, :].copy()


def big_vandermonde_distribution_matrix(rows: int, cols: int) -> np.ndarray:
    """reed_sol.c :: reed_sol_big_vandermonde_distribution_matrix (w=8)."""
    if rows < cols:
        raise ValueError("rows < cols")
    dist = np.zeros((rows, cols), dtype=np.int64)
    for i in range(rows):
        dist[i, 0] = 1
        for j in range(1, cols):
            dist[i, j] = gf_mul(int(dist[i, j - 1]), i)

    # Gauss-Jordan by columns: make top cols x cols block the identity.
    for i in range(1, cols):
        # find a column j >= i with a nonzero pivot in row i
        j = i
        while j < cols and dist[i, j] == 0:
            j += 1
        if j == cols:
            raise ValueError("singular Vandermonde block (unexpected for w=8)")
        if j != i:
            dist[:, [i, j]] = dist[:, [j, i]]
        if dist[i, i] != 1:
            inv = gf_div(1, int(dist[i, i]))
            for r in range(rows):
                dist[r, i] = gf_mul(inv, int(dist[r, i]))
        for j2 in range(cols):
            tmp = int(dist[i, j2])
            if j2 != i and tmp != 0:
                for r in range(rows):
                    dist[r, j2] ^= gf_mul(tmp, int(dist[r, i]))

    # Scale so the first coding row (row `cols`) is all ones; jerasure applies
    # the compensating scaling only to rows below it (the identity rows' own
    # compensation would be row scalings that cancel — it skips the no-op).
    for j in range(cols):
        tmp = int(dist[cols, j])
        if tmp == 0:
            raise ValueError("zero in first coding row (unexpected)")
        if tmp != 1:
            inv = gf_div(1, tmp)
            dist[cols, j] = 1
            for r in range(cols + 1, rows):
                dist[r, j] = gf_mul(inv, int(dist[r, j]))
    return dist


def cauchy_original_coding_matrix(k: int, m: int) -> np.ndarray:
    """cauchy.c :: cauchy_original_coding_matrix: M[i][j] = 1/(i ^ (m+j))."""
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for w=8")
    mat = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            mat[i, j] = gf_inv(i ^ (m + j))
    return mat


def cauchy_n_ones(n: int, w: int = 8) -> int:
    """cauchy.c :: cauchy_n_ones — number of 1 bits in the w x w bitmatrix of
    multiply-by-n, i.e. sum over column x of popcount(n * 2^x)."""
    total = 0
    e = n
    for _ in range(w):
        total += bin(e).count("1")
        e = gf_mul(e, 2)
    return total


def cauchy_improve_coding_matrix(mat: np.ndarray) -> np.ndarray:
    """cauchy.c :: cauchy_improve_coding_matrix.

    (1) scale each column so row 0 is all ones; (2) for each later row, try
    dividing the row by each of its non-one elements and keep the divisor that
    minimizes the total bitmatrix ones (strict improvement, first winner on
    ties as jerasure's scan order produces).
    """
    mat = mat.copy()
    m, k = mat.shape
    for j in range(k):
        if mat[0, j] != 1:
            inv = gf_div(1, int(mat[0, j]))
            for i in range(m):
                mat[i, j] = gf_mul(int(mat[i, j]), inv)
    for i in range(1, m):
        bno = sum(cauchy_n_ones(int(mat[i, j])) for j in range(k))
        bno_index = -1
        for j in range(k):
            if mat[i, j] != 1:
                inv = gf_div(1, int(mat[i, j]))
                tno = sum(
                    cauchy_n_ones(gf_mul(int(mat[i, x]), inv)) for x in range(k)
                )
                if tno < bno:
                    bno = tno
                    bno_index = j
        if bno_index != -1:
            inv = gf_div(1, int(mat[i, bno_index]))
            for j in range(k):
                mat[i, j] = gf_mul(int(mat[i, j]), inv)
    return mat


def cauchy_good_coding_matrix(k: int, m: int) -> np.ndarray:
    """cauchy.c :: cauchy_good_general_coding_matrix, technique cauchy_good.

    Vintage note: jerasure special-cases m==2, k <= cbest_max_k with
    precomputed "best" rows; those tables were not reproducible without the
    reference source (mount empty, SURVEY.md §0), so m==2 also goes through
    original+improve here.  None of the BASELINE.json configs use m=2.
    """
    return cauchy_improve_coding_matrix(cauchy_original_coding_matrix(k, m))


def matrix_to_bitmatrix(mat: np.ndarray, w: int = 8) -> np.ndarray:
    """jerasure.c :: jerasure_matrix_to_bitmatrix.

    Each GF element e expands to a w x w 0/1 block B with B[l, x] = bit l of
    (e * 2^x): column x is the bit pattern of e times the basis element x^x.
    Multiplying the w bit-planes of a data chunk by B (over GF(2)) equals
    GF(2^8)-multiplying every byte by e — the linearity trick that turns RS
    encode into pure XOR, which is what ops/gf_kernels.apply_matrix_plain
    runs.
    """
    if w != 8:
        raise ValueError(f"only w=8 is supported, got {w}")
    mat = np.asarray(mat, dtype=np.uint8)
    rows, cols = mat.shape
    basis = np.left_shift(1, np.arange(w)).astype(np.uint8)     # x^x
    prod = GF_MUL_TABLE[mat[:, :, None], basis[None, None, :]]  # [i, j, x]
    bits = (prod[:, :, :, None] >> np.arange(w, dtype=np.uint8)) & 1  # [i, j, x, l]
    return np.ascontiguousarray(bits.transpose(0, 3, 1, 2)).reshape(rows * w, cols * w)


def _rref(A: np.ndarray, B: np.ndarray | None) -> list[int]:
    """Reduce A to reduced row echelon form over GF(2^8), in place, applying
    the same row operations to B (the augmented block) when given.  Returns
    the pivot column indices.  Shared engine of invert_matrix / gf_rank /
    gf_solve — one elimination loop to keep bit-exact semantics in one place.

    Entries must be bytes (0..255) regardless of dtype; B may be wide chunk
    data (vectorized via the GF multiplication table).
    """
    from .tables import GF_MUL_TABLE

    rows, cols = A.shape
    row = 0
    pivots: list[int] = []
    for c in range(cols):
        piv = next((r for r in range(row, rows) if A[r, c] != 0), None)
        if piv is None:
            continue
        if piv != row:
            A[[row, piv]] = A[[piv, row]]
            if B is not None:
                B[[row, piv]] = B[[piv, row]]
        inv = gf_inv(int(A[row, c]))
        if inv != 1:
            A[row] = _row_scale(A[row], inv)
            if B is not None:
                B[row] = _row_scale(B[row], inv)
        for r in range(rows):
            if r != row and A[r, c] != 0:
                f = int(A[r, c])
                A[r] ^= _row_scale(A[row], f)
                if B is not None:
                    B[r] ^= _row_scale(B[row], f)
        pivots.append(c)
        row += 1
        if row == rows:
            break
    return pivots


def invert_matrix(mat: np.ndarray) -> np.ndarray:
    """GF(2^8) Gauss-Jordan inversion (jerasure.c :: jerasure_invert_matrix).

    Used on the host to build per-erasure-pattern decode matrices, which are
    cached per pattern exactly as the reference's ISA-L plugin caches them
    (reference: src/erasure-code/isa/ErasureCodeIsaTableCache.cc).
    """
    mat = np.array(mat, dtype=np.int64)
    n = mat.shape[0]
    if mat.shape != (n, n):
        raise ValueError("square matrix required")
    inv = np.eye(n, dtype=np.int64)
    if len(_rref(mat, inv)) != n:
        raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
    return inv


def gf_rank(mat: np.ndarray) -> int:
    """Rank of a GF(2^8) matrix (row echelon by Gaussian elimination)."""
    return len(_rref(np.array(mat, dtype=np.int64), None))


def gf_solve(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Solve A @ X = B over GF(2^8) for X (unique solution required).

    A: [n_eq, n_unk] coefficients, B: [n_eq, L] right-hand chunks.
    Used by the SHEC/LRC decoders where the system is windowed parities
    rather than a square generator submatrix (reference:
    src/erasure-code/shec/ErasureCodeShec.cc builds and inverts the
    analogous recovery system).  Raises LinAlgError if under-determined.
    """
    A = np.array(A, dtype=np.int64)
    B = np.array(B, dtype=np.int64)
    n_eq, n_unk = A.shape
    if B.shape[0] != n_eq:
        raise ValueError("A and B row mismatch")
    aug_a = A.copy()
    aug_b = B.copy()
    pivots = _rref(aug_a, aug_b)
    if len(pivots) < n_unk:
        raise np.linalg.LinAlgError("GF system under-determined")
    X = np.zeros((n_unk, B.shape[1]), dtype=np.int64)
    for r, c in enumerate(pivots):
        X[c] = aug_b[r]
    return X.astype(np.uint8)


def _row_scale(row: np.ndarray, f: int) -> np.ndarray:
    from .tables import GF_MUL_TABLE

    return GF_MUL_TABLE[f, row.astype(np.uint8)].astype(np.int64)


def systematic_generator(coding: np.ndarray) -> np.ndarray:
    """[I_k ; C] — full (k+m) x k generator for a systematic code."""
    m, k = coding.shape
    return np.vstack([np.eye(k, dtype=np.int64), coding.astype(np.int64)])


def decode_matrix_for(
    generator: np.ndarray, k: int, available_rows: list[int]
) -> np.ndarray:
    """Invert the k x k generator submatrix of the first k available shards.

    Mirrors jerasure.c :: jerasure_make_decoding_matrix: pick k surviving
    rows of the generator, invert; multiplying surviving chunks by the
    inverse reconstructs the data chunks.
    """
    if len(available_rows) < k:
        raise ValueError("need at least k available shards to decode")
    sub = generator[np.asarray(available_rows[:k], dtype=np.int64), :]
    return invert_matrix(sub)
