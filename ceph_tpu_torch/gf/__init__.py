"""GF(2^8) arithmetic, RS/Cauchy matrix construction, numpy reference codec.

The port's counterpart of ceph_tpu/gf, with the same exports: the
reference's gf-complete + jerasure matrix layer (reference:
src/erasure-code/jerasure/{gf-complete,jerasure}).
"""
from .matrix import (
    big_vandermonde_distribution_matrix,
    cauchy_good_coding_matrix,
    cauchy_n_ones,
    cauchy_original_coding_matrix,
    decode_matrix_for,
    invert_matrix,
    matrix_to_bitmatrix,
    systematic_generator,
    vandermonde_coding_matrix,
)
from .tables import (
    GF_EXP,
    GF_INV_TABLE,
    GF_LOG,
    GF_MUL_TABLE,
    GF_POLY,
    gf_div,
    gf_inv,
    gf_matmul,
    gf_mul,
    gf_mul_vec,
    gf_pow,
)

__all__ = [
    "GF_EXP", "GF_INV_TABLE", "GF_LOG", "GF_MUL_TABLE", "GF_POLY",
    "gf_div", "gf_inv", "gf_matmul", "gf_mul", "gf_mul_vec", "gf_pow",
    "big_vandermonde_distribution_matrix", "cauchy_good_coding_matrix",
    "cauchy_n_ones", "cauchy_original_coding_matrix", "decode_matrix_for",
    "invert_matrix", "matrix_to_bitmatrix", "systematic_generator",
    "vandermonde_coding_matrix",
]
