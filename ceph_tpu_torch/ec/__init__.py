"""Erasure-code codec layer of the port: interface, registry, plugins,
stripe math (counterpart of ceph_tpu/ec)."""
from .interface import (
    ErasureCode,
    ErasureCodeInterface,
    InsufficientChunks,
    InvalidProfile,
)
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry
from .stripe import StripeInfo

__all__ = [
    "ErasureCode",
    "ErasureCodeInterface",
    "ErasureCodePlugin",
    "ErasureCodePluginRegistry",
    "InsufficientChunks",
    "InvalidProfile",
    "StripeInfo",
]
