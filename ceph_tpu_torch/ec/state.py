"""State carried across from the JAX package: the coding matrices.

For a storage system the state is the coding matrices and the data already
on disk.  ``codec_from_arrays`` builds the port's codec for a profile and
installs matrices another implementation built, handed over as numpy
arrays, so shards written under those matrices decode here:

    "coding"                          the codec's [m, k] coding matrix
    "repair_matrix/<lost>/<h0,h1,..>" a CLAY repair matrix for (lost, helpers)
"""
from __future__ import annotations

import numpy as np

from .interface import ErasureCodeInterface
from .registry import ErasureCodePluginRegistry


def repair_matrix_name(lost: int, helpers) -> str:
    """The array name of a CLAY repair matrix for (lost, helpers)."""
    return f"repair_matrix/{int(lost)}/{','.join(str(int(h)) for h in helpers)}"


def codec_from_arrays(profile: dict, arrays: dict[str, np.ndarray],
                      device=None) -> ErasureCodeInterface:
    """The port's codec for `profile`, carrying the given matrices."""
    codec = ErasureCodePluginRegistry.instance().factory(profile, device=device)
    for name, arr in arrays.items():
        if name == "coding":
            codec.set_coding(arr)
        elif name.startswith("repair_matrix/") and hasattr(codec, "set_repair_matrix"):
            _, lost, helpers = name.split("/")
            codec.set_repair_matrix(
                int(lost), tuple(int(h) for h in helpers.split(",")), arr)
        else:
            raise KeyError(f"{type(codec).__name__} takes no array {name!r}")
    return codec
