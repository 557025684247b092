"""CRUSH placement: straw2 + rule interpreter, batched on a torch device.

The port's counterpart of ceph_tpu/crush (reference: src/crush).  The
batch mapper's straw2 draws run in the hand-written CUDA kernel K3
(ops/crush_kernels.py) on the card.
"""
from .builder import (
    add_simple_rule,
    build_flat_map,
    build_hierarchical_map,
    make_straw2_bucket,
)
from .mapper import CompiledCrushMap, crush_do_rule_batch
from .reference_mapper import bucket_straw2_choose, crush_do_rule
from .types import ITEM_NONE, CrushMap, Rule, RuleOp, RuleStep, Straw2Bucket, Tunables
from .wrapper import CrushWrapper

__all__ = [
    "ITEM_NONE",
    "CompiledCrushMap",
    "CrushMap",
    "CrushWrapper",
    "Rule",
    "RuleOp",
    "RuleStep",
    "Straw2Bucket",
    "Tunables",
    "add_simple_rule",
    "bucket_straw2_choose",
    "build_flat_map",
    "build_hierarchical_map",
    "crush_do_rule",
    "crush_do_rule_batch",
    "make_straw2_bucket",
]
