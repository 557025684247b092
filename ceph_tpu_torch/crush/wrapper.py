"""CrushWrapper analog — name/id management, rule building, text form.

The port's counterpart of ceph_tpu/crush/wrapper.py: the same API, text
grammar and edits, with ``do_rule_batch`` taking a ``device`` (``cuda``
unless the caller passes ``device="cpu"``).

Reference: src/crush/CrushWrapper.{h,cc} — owns a crush_map, resolves
names<->ids, creates rules (add_simple_rule), and drives crush_do_rule with
allocated work buffers; plus src/crush/CrushCompiler.{h,cc} — the text <->
binary map grammar used by crushtool compile/decompile.

The text grammar here mirrors the crushtool decompile format closely enough
to be familiar (tunables / devices / types / buckets / rules sections), and
round-trips losslessly through parse_text/format_text — the property the
reference's cram tests assert for crushtool (reference:
src/test/cli/crushtool/*.t, SURVEY.md §4 ring 1).
"""
from __future__ import annotations

import copy
import hashlib
import threading
from collections import OrderedDict

import numpy as np

import torch

from ..common.device import resolve_device
from .mapper import CompiledCrushMap, crush_do_rule_batch, validate_choose_args
from .reference_mapper import crush_do_rule
from .types import BUCKET_ALG_NAMES, BUCKET_STRAW, BUCKET_TREE, BUCKET_UNIFORM, CrushMap, Rule, RuleOp, RuleStep, Straw2Bucket, Tunables

#: process-wide CompiledCrushMap cache keyed by map CONTENT digest and
#: device.  Every osdmap epoch decodes to a FRESH CrushWrapper whose
#: compiled form would otherwise be rebuilt and uploaded to the device
#: again even though the crush content is byte-identical.  Entries own a
#: PRIVATE deepcopy of the map so a source wrapper mutating its live map
#: in place (mon-side edits) can never skew a cached entry other wrappers
#: share.
_COMPILED_CACHE_MAX = 8
_COMPILED_CACHE: OrderedDict[tuple[str, str], CompiledCrushMap] = OrderedDict()
_COMPILED_CACHE_LOCK = threading.Lock()

_OP_NAMES = {
    RuleOp.TAKE: "take",
    RuleOp.CHOOSE_FIRSTN: "choose firstn",
    RuleOp.CHOOSE_INDEP: "choose indep",
    RuleOp.CHOOSELEAF_FIRSTN: "chooseleaf firstn",
    RuleOp.CHOOSELEAF_INDEP: "chooseleaf indep",
    RuleOp.EMIT: "emit",
    RuleOp.SET_CHOOSE_TRIES: "set_choose_tries",
    RuleOp.SET_CHOOSELEAF_TRIES: "set_chooseleaf_tries",
}


class CrushWrapper:
    """Owns a CrushMap; the API surface OSDMap and the tools build on."""

    def __init__(self, cmap: CrushMap | None = None):
        self.map = cmap or CrushMap()
        self._compiled: dict[str, CompiledCrushMap] = {}
        self._content_digest: str | None = None

    def __deepcopy__(self, memo):
        # a scratch copy (balancer pass) must not deep-copy the compiled
        # device tables — the copy re-resolves them from the
        # content-digest cache (crush content is unchanged by pg_upmap
        # edits, so it's a hit)
        cls = self.__class__
        new = cls.__new__(cls)
        memo[id(self)] = new
        new.map = copy.deepcopy(self.map, memo)
        new._compiled = {}
        # a copy has identical content by definition — keep the digest
        # (None if never computed) so the scratch's first compiled()
        # lookup skips the O(map) format_text+sha1 rebuild
        new._content_digest = self._content_digest
        return new

    # -- names ------------------------------------------------------------
    def name_of(self, item: int) -> str:
        if item >= 0:
            return self.map.device_names.get(item, f"osd.{item}")
        return self.map.bucket_names.get(item, f"bucket{item}")

    def id_of(self, name: str) -> int:
        if name.startswith("osd."):
            return int(name[4:])
        for bid, n in self.map.bucket_names.items():
            if n == name:
                return bid
        for did, n in self.map.device_names.items():
            if n == name:
                return did
        raise KeyError(f"unknown crush name {name!r}")

    def type_name(self, t: int) -> str:
        return self.map.type_names.get(t, f"type{t}")

    def type_id(self, name: str) -> int:
        for tid, n in self.map.type_names.items():
            if n == name:
                return tid
        raise KeyError(f"unknown crush type {name!r}")

    # -- device classes ----------------------------------------------------
    # reference: CrushWrapper::class_name / set_item_class /
    # populate_classes / device_class_clone — per-class "shadow trees" so a
    # rule can `take default class ssd` and descend only over devices of
    # that class.  Shadow buckets are ordinary straw2 buckets (negative ids
    # past the originals, named "<bucket>~<class>"), so the batch mapper and
    # the C++ oracle need no special casing.

    def class_id(self, name: str, create: bool = False) -> int:
        for cid, n in self.map.class_names.items():
            if n == name:
                return cid
        if not create:
            raise KeyError(f"unknown device class {name!r}")
        cid = max(self.map.class_names, default=-1) + 1
        self.map.class_names[cid] = name
        return cid

    def set_device_class(self, osd: int, name: str) -> None:
        """Tag a device; call populate_classes() once after tagging."""
        self.map.device_classes[osd] = self.class_id(name, create=True)

    def get_device_class(self, osd: int) -> str | None:
        cid = self.map.device_classes.get(osd)
        return None if cid is None else self.map.class_names[cid]

    def _shadow_index(self) -> dict[int, tuple[int, int]]:
        """shadow bucket id -> (original bucket id, class id) — the single
        inversion of class_bucket shared by the shadow-tree builder, the
        original-bucket filter, and the text form."""
        return {
            sid: (bid, cid)
            for bid, per in self.map.class_bucket.items()
            for cid, sid in per.items()
        }

    def _original_buckets(self) -> list[int]:
        shadows = self._shadow_index()
        return [b for b in self.map.buckets if b not in shadows]

    def _topo_order(self, bucket_ids) -> list[int]:
        """Children-before-parents order over the given buckets — shared by
        the text form and the shadow-tree builder so both orderings can
        never drift apart."""
        order: list[int] = []
        done: set[int] = set()

        def emit(bid: int) -> None:
            if bid in done:
                return
            done.add(bid)
            for child in self.map.buckets[bid].items:
                if child < 0:
                    emit(child)
            order.append(bid)

        for bid in sorted(bucket_ids):
            emit(bid)
        return order

    def populate_classes(self) -> None:
        """(Re)build the per-class shadow trees (reference:
        CrushWrapper::populate_classes -> device_class_clone).

        Existing rules that TAKE a shadow bucket are re-pointed at the
        rebuilt shadow for the same (original bucket, class)."""
        m = self.map
        old_shadow = self._shadow_index()
        for sid in old_shadow:
            m.buckets.pop(sid, None)
            m.bucket_names.pop(sid, None)
        m.class_bucket = {}
        if m.class_names:
            # children-before-parents so a shadow can reference its
            # children's shadows
            order = self._topo_order(list(m.buckets))
            next_id = min(m.buckets, default=0) - 1
            for cid in sorted(m.class_names):
                shadow_of: dict[int, int] = {}
                for bid in order:
                    b = m.buckets[bid]
                    items: list[int] = []
                    weights: list[int] = []
                    for it, w in zip(b.items, b.weights):
                        if it >= 0:
                            if m.device_classes.get(it) == cid:
                                items.append(it)
                                weights.append(w)
                        else:
                            sid = shadow_of[it]
                            items.append(sid)
                            weights.append(m.buckets[sid].weight)
                    sid = next_id
                    next_id -= 1
                    m.buckets[sid] = Straw2Bucket(
                        id=sid, type=b.type, items=items, weights=weights
                    )
                    m.bucket_names[sid] = (
                        f"{self.name_of(bid)}~{m.class_names[cid]}"
                    )
                    shadow_of[bid] = sid
                    m.class_bucket.setdefault(bid, {})[cid] = sid
        for rule in m.rules.values():
            for step in rule.steps:
                if step.op == RuleOp.TAKE and step.arg1 in old_shadow:
                    bid, cid = old_shadow[step.arg1]
                    step.arg1 = m.class_bucket[bid][cid]
        self.invalidate()

    def shadow_root(self, root: int, class_name: str) -> int:
        """Shadow bucket id for (root, class) — what `take X class c`
        compiles to."""
        cid = self.class_id(class_name)
        try:
            return self.map.class_bucket[root][cid]
        except KeyError:
            raise KeyError(
                f"no shadow tree for bucket {root} class {class_name!r}; "
                "call populate_classes() after tagging devices"
            ) from None

    def add_simple_rule(
        self,
        root_name: str,
        failure_domain: str,
        device_class: str | None = None,
        rule_id: int | None = None,
        firstn: bool = True,
        num_replicas: int = 0,
    ):
        """reference: CrushWrapper::add_simple_rule (incl. the device-class
        form used by `ceph osd crush rule create-replicated`)."""
        from .builder import add_simple_rule as _add

        root = self.id_of(root_name)
        if device_class is not None:
            root = self.shadow_root(root, device_class)
        rule = _add(
            self.map,
            root,
            self.type_id(failure_domain),
            rule_id=rule_id,
            firstn=firstn,
            num_replicas=num_replicas,
        )
        self.invalidate()
        return rule

    def reweight_item(self, name: str, weight: float) -> None:
        """`ceph osd crush reweight` (reference: CrushWrapper::
        adjust_item_weightf + the upward weight propagation of
        crush_reweight_bucket): set a DEVICE's crush weight and
        recompute every ancestor bucket-entry weight bottom-up —
        including legacy straw/tree aux tables, which derive from
        weights and must follow a legitimate weight change (unlike
        ingest, where they are authoritative and kept verbatim)."""
        item = self.id_of(name)
        if item < 0:
            raise ValueError(f"{name!r} is a bucket; reweight devices")
        fixed = int(round(weight * 0x10000))
        if fixed < 0:
            raise ValueError(f"weight {weight} must be >= 0")
        found = False
        for b in self.map.buckets.values():
            for i, it in enumerate(b.items):
                if it == item:
                    b.weights[i] = fixed
                    found = True
        if not found:
            raise KeyError(f"device {name!r} is in no bucket")
        self._propagate_weights()
        self.invalidate()

    def add_bucket(self, name: str, type_name: str) -> int:
        """`ceph osd crush add-bucket` (reference:
        CrushWrapper::add_bucket): a new empty straw2 bucket, detached
        until `move` places it under a parent."""
        from .types import BUCKET_STRAW2, Straw2Bucket

        if name in {*self.map.bucket_names.values(),
                    *self.map.device_names.values()}:
            raise ValueError(f"name {name!r} exists")
        t = self.type_id(type_name)
        if t <= 0:
            raise ValueError(f"bad bucket type {type_name!r}")
        bid = min(self.map.buckets, default=0) - 1
        self.map.buckets[bid] = Straw2Bucket(
            id=bid, type=t, alg=BUCKET_STRAW2, items=[], weights=[])
        self.map.bucket_names[bid] = name
        self.invalidate()
        return bid

    def move_item(self, name: str, parent_name: str) -> None:
        """`ceph osd crush move` / `crush add` placement (reference:
        CrushWrapper::move_bucket / insert_item): detach `name` from
        its current parent (if any) and attach under `parent_name`,
        keeping its subtree weight; ancestors re-propagate."""
        item = self.id_of(name)
        dest = self.id_of(parent_name)
        if dest >= 0:
            raise ValueError(f"{parent_name!r} is a device")
        if dest not in self.map.buckets:
            raise KeyError(f"no bucket {parent_name!r}")
        if item >= 0 and item not in self.map.device_names \
                and item >= self.map.max_devices:
            # upstream rejects with ENOENT; inserting a ghost device
            # would map PGs onto an id no OSD owns
            raise KeyError(f"no device {name!r}")
        if item < 0:
            # moving a bucket under its own subtree would cycle
            probe = dest
            seen = set()
            while probe is not None and probe not in seen:
                if probe == item:
                    raise ValueError(
                        f"cannot move {name!r} under its own subtree")
                seen.add(probe)
                probe = next(
                    (b.id for b in self.map.buckets.values()
                     if probe in b.items), None)
        shadows = set(self._shadow_index())
        weight = None
        for b in self.map.buckets.values():
            if b.id not in shadows and item in b.items:
                i = b.items.index(item)
                weight = b.weights[i]
                del b.items[i]
                del b.weights[i]
        if weight is None:
            weight = (sum(self.map.buckets[item].weights)
                      if item < 0 else 0x10000)
        dst = self.map.buckets[dest]
        dst.items.append(item)
        dst.weights.append(weight)
        self._propagate_weights()
        if self.map.class_bucket:
            # class shadow trees mirror the real topology — rebuild
            # them or `take X class c` rules lose the moved subtree
            self.populate_classes()
        self.invalidate()

    def remove_item(self, name: str) -> None:
        """`ceph osd crush rm` (reference: CrushWrapper::remove_item):
        detach a device or EMPTY bucket from the tree."""
        item = self.id_of(name)
        if item < 0:
            if self.map.buckets.get(item) is None:
                raise KeyError(name)
            if self.map.buckets[item].items:
                raise ValueError(f"bucket {name!r} is not empty")
        shadows = set(self._shadow_index())
        found = False
        for b in self.map.buckets.values():
            if b.id not in shadows and item in b.items:
                i = b.items.index(item)
                del b.items[i]
                del b.weights[i]
                found = True
        if item >= 0 and not found:
            raise KeyError(f"{name!r} is in no bucket")
        if item < 0:
            del self.map.buckets[item]
            self.map.bucket_names.pop(item, None)
            for orig, per_class in list(self.map.class_bucket.items()):
                if orig == item:
                    for sid in per_class.values():
                        self.map.buckets.pop(sid, None)
                        self.map.bucket_names.pop(sid, None)
                    del self.map.class_bucket[orig]
        self._propagate_weights()
        if self.map.class_bucket:
            self.populate_classes()
        self.invalidate()

    def _propagate_weights(self) -> None:
        """Bottom-up: a bucket entry that IS a bucket weighs the sum of
        that bucket's items; straw/tree aux tables recompute from the
        new weights."""
        from .builder import calc_straws, calc_tree_nodes
        from .types import (BUCKET_STRAW, BUCKET_STRAW2,
                            BUCKET_TREE)

        order = self._topo_order(list(self.map.buckets))
        totals: dict[int, int] = {}
        for bid in order:  # children before parents
            b = self.map.buckets[bid]
            for i, it in enumerate(b.items):
                if it < 0:
                    b.weights[i] = totals.get(it, b.weights[i])
            totals[bid] = sum(b.weights)
            if getattr(b, "alg", BUCKET_STRAW2) == BUCKET_STRAW:
                b.straws = calc_straws(b.weights)
            elif getattr(b, "alg", BUCKET_STRAW2) == BUCKET_TREE:
                b.node_weights = calc_tree_nodes(b.weights)

    def get_rule_weight_osd_map(self, rule_id: int) -> dict[int, float]:
        """reference: CrushWrapper::get_rule_weight_osd_map — the crush
        weight of every device reachable from the rule's TAKE roots (so a
        device-class rule only counts its shadow subtree).  Consumers:
        utilization expectations (CrushTester) and pool balance targets."""
        out: dict[int, float] = {}

        def walk(bid: int) -> None:
            b = self.map.buckets[bid]
            for it, w in zip(b.items, b.weights):
                if it >= 0:
                    out[it] = out.get(it, 0.0) + w / 0x10000
                else:
                    walk(it)

        for step in self.map.rules[rule_id].steps:
            if step.op == RuleOp.TAKE:
                if step.arg1 >= 0:
                    out[step.arg1] = out.get(step.arg1, 0.0) + 1.0
                else:
                    walk(step.arg1)
        return out

    # -- choose_args (weight-sets) ----------------------------------------
    def set_choose_args(
        self, name: str, bucket_id: int, weight_set: list[list[int]]
    ) -> None:
        """Install an alternate weight set for one bucket (reference:
        crush_choose_arg_map; written by the balancer's crush-compat mode).

        weight_set: [positions][bucket size] 16.16 fixed-point weights."""
        if not weight_set:
            raise ValueError("weight_set must have at least one position row")
        b = self.map.buckets[bucket_id]
        for ws in weight_set:
            if len(ws) != b.size:
                raise ValueError(
                    f"weight_set row has {len(ws)} entries, bucket "
                    f"{bucket_id} has {b.size} items"
                )
        self.map.choose_args.setdefault(name, {})[bucket_id] = [
            list(ws) for ws in weight_set
        ]
        self.invalidate()

    def rm_choose_args(self, name: str) -> None:
        self.map.choose_args.pop(name, None)
        self.invalidate()

    # -- mapping ----------------------------------------------------------
    def invalidate(self) -> None:
        self._compiled = {}
        self._content_digest = None

    def content_digest(self) -> str:
        """Digest of the full text form — the same canonical content an
        osdmap round-trips (to_json carries crush as text), so two
        wrappers mapping identically share one digest."""
        if self._content_digest is None:
            self._content_digest = hashlib.sha1(
                self.format_text().encode()).hexdigest()
        return self._content_digest

    def compiled(self, device=None) -> CompiledCrushMap:
        """The map's dense tensors on `device` (``cuda`` by default)."""
        dev = resolve_device(device)
        if str(dev) not in self._compiled:
            key = (self.content_digest(), str(dev))
            with _COMPILED_CACHE_LOCK:
                hit = _COMPILED_CACHE.get(key)
                if hit is not None:
                    _COMPILED_CACHE.move_to_end(key)
            if hit is None:
                built = CompiledCrushMap(copy.deepcopy(self.map), dev)
                with _COMPILED_CACHE_LOCK:
                    # first build wins so concurrent callers share one entry
                    hit = _COMPILED_CACHE.setdefault(key, built)
                    _COMPILED_CACHE.move_to_end(key)
                    while len(_COMPILED_CACHE) > _COMPILED_CACHE_MAX:
                        _COMPILED_CACHE.popitem(last=False)
            self._compiled[str(dev)] = hit
        return self._compiled[str(dev)]

    def do_rule(
        self,
        rule_id: int,
        x: int,
        numrep: int,
        weights,
        choose_args: str | None = None,
    ) -> list[int]:
        """Single mapping (reference: CrushWrapper::do_rule; choose_args
        names a weight-set, the choose_args_index analog)."""
        ca = (
            validate_choose_args(self.map, choose_args)
            if choose_args is not None
            else None
        )
        return crush_do_rule(
            self.map, rule_id, x, numrep, list(weights), choose_args=ca
        )

    def do_rule_batch(
        self,
        rule_id: int,
        xs,
        numrep: int,
        weights,
        choose_args: str | None = None,
        device=None,
    ) -> torch.Tensor:
        """Batched mapping: xs [N] -> [N, numrep] int32 tensor on `device`
        (``cuda`` unless given ``device="cpu"``)."""
        return crush_do_rule_batch(
            self.compiled(device),
            rule_id,
            xs,
            numrep,
            weights,
            choose_args=choose_args,
        )

    # -- text form (CrushCompiler analog) ---------------------------------
    def format_text(self) -> str:
        m = self.map
        t = m.tunables
        lines = ["# begin crush map"]
        for k in (
            "choose_total_tries",
            "choose_local_tries",
            "choose_local_fallback_tries",
            "chooseleaf_descend_once",
            "chooseleaf_vary_r",
            "chooseleaf_stable",
        ):
            lines.append(f"tunable {k} {getattr(t, k)}")
        if m.class_names:
            # Divergence from crushtool's grammar, on purpose: class ids are
            # explicit (and precede the devices that name them) so
            # decompile→compile preserves them.  Shadow-tree bucket ids
            # derive from class-id order, and those ids feed the straw2
            # descent hash — inferring class ids from device-line order
            # would silently remap every class-rule pool whose classes were
            # created in non-device-id order.
            lines.append("")
            lines.append("# classes")
            for cid in sorted(m.class_names):
                lines.append(f"class {cid} {m.class_names[cid]}")
        lines.append("")
        lines.append("# devices")
        for d in range(m.max_devices):
            cls = self.get_device_class(d)
            suffix = f" class {cls}" if cls else ""
            lines.append(f"device {d} {self.name_of(d)}{suffix}")
        lines.append("")
        lines.append("# types")
        for tid in sorted(m.type_names):
            lines.append(f"type {tid} {m.type_names[tid]}")
        lines.append("")
        lines.append("# buckets")
        # topological order (children before parents) so parse_text never
        # sees a forward reference — crushtool decompile does the same.
        # Shadow buckets are omitted: like crushtool, the text form shows
        # only the original hierarchy and class-annotated take steps, and
        # the compiler rebuilds the shadow trees.
        emitted = self._topo_order(self._original_buckets())
        for bid in emitted:
            b = m.buckets[bid]
            lines.append(f"{self.type_name(b.type)} {self.name_of(bid)} {{")
            lines.append(f"\tid {bid}")
            lines.append(f"\talg {BUCKET_ALG_NAMES[getattr(b, 'alg', 5)]}")
            lines.append("\thash 0\t# rjenkins1")
            for it, w in zip(b.items, b.weights):
                lines.append(f"\titem {self.name_of(it)} weight {w / 0x10000:.5f}")
            lines.append("}")
        lines.append("")
        lines.append("# rules")
        shadow_to = self._shadow_index()
        for rid in sorted(m.rules):
            r = m.rules[rid]
            lines.append(f"rule rule{rid} {{")
            lines.append(f"\tid {rid}")
            lines.append(f"\ttype {'replicated' if r.type == 1 else 'erasure'}")
            for s in r.steps:
                if s.op == RuleOp.TAKE:
                    if s.arg1 in shadow_to:
                        bid, cid = shadow_to[s.arg1]
                        lines.append(
                            f"\tstep take {self.name_of(bid)} "
                            f"class {m.class_names[cid]}"
                        )
                    else:
                        lines.append(f"\tstep take {self.name_of(s.arg1)}")
                elif s.op == RuleOp.EMIT:
                    lines.append("\tstep emit")
                elif s.op in (RuleOp.SET_CHOOSE_TRIES, RuleOp.SET_CHOOSELEAF_TRIES):
                    lines.append(f"\tstep {_OP_NAMES[s.op]} {s.arg1}")
                else:
                    lines.append(
                        f"\tstep {_OP_NAMES[s.op]} {s.arg1} type "
                        f"{self.type_name(s.arg2)}"
                    )
            lines.append("}")
        if m.choose_args:
            lines.append("")
            lines.append("# choose_args")
            for name in sorted(m.choose_args):
                lines.append(f"choose_args {name} {{")
                for bid in sorted(m.choose_args[name]):
                    rows = " ".join(
                        "[" + " ".join(f"{w / 0x10000:.5f}" for w in ws) + "]"
                        for ws in m.choose_args[name][bid]
                    )
                    lines.append(f"\tbucket {bid} weight_set {rows}")
                lines.append("}")
        lines.append("# end crush map")
        return "\n".join(lines) + "\n"

    @classmethod
    def parse_text(cls, text: str) -> "CrushWrapper":
        """Inverse of format_text (CrushCompiler::compile analog)."""
        w = cls(CrushMap())
        m = w.map
        m.type_names = {}
        cur_bucket: Straw2Bucket | None = None
        cur_rule: Rule | None = None
        cur_choose_args: str | None = None
        pending_items: list[tuple[str, float]] = []
        bucket_header: tuple[str, str] | None = None
        names_to_resolve: dict[str, int] = {}
        # take-with-class steps resolve only after the shadow trees are
        # rebuilt at the end of the parse: (RuleStep, root name, class name)
        pending_class_takes: list[tuple[RuleStep, str, str]] = []

        def resolve(name: str) -> int:
            if name.startswith("osd."):
                return int(name[4:])
            if name in names_to_resolve:
                return names_to_resolve[name]
            raise KeyError(f"forward reference to {name!r}")

        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            tok = line.split()
            # block context first: keywords like "type" also appear inside
            # rule/bucket bodies
            if cur_rule is not None:
                if tok[0] == "id":
                    cur_rule.rule_id = int(tok[1])
                elif tok[0] == "type":
                    cur_rule.type = 1 if tok[1] == "replicated" else 3
                elif tok[0] == "step":
                    op = " ".join(tok[1:3]) if tok[1] in ("choose", "chooseleaf") else tok[1]
                    if op == "take":
                        step = RuleStep(RuleOp.TAKE, 0)
                        if len(tok) >= 5 and tok[3] == "class":
                            pending_class_takes.append((step, tok[2], tok[4]))
                        else:
                            step.arg1 = resolve(tok[2])
                        cur_rule.steps.append(step)
                    elif op == "emit":
                        cur_rule.steps.append(RuleStep(RuleOp.EMIT))
                        m.rules[cur_rule.rule_id] = cur_rule
                    elif op in ("set_choose_tries", "set_chooseleaf_tries"):
                        o = (
                            RuleOp.SET_CHOOSE_TRIES
                            if op == "set_choose_tries"
                            else RuleOp.SET_CHOOSELEAF_TRIES
                        )
                        cur_rule.steps.append(RuleStep(o, int(tok[2])))
                    else:
                        ops = {
                            "choose firstn": RuleOp.CHOOSE_FIRSTN,
                            "choose indep": RuleOp.CHOOSE_INDEP,
                            "chooseleaf firstn": RuleOp.CHOOSELEAF_FIRSTN,
                            "chooseleaf indep": RuleOp.CHOOSELEAF_INDEP,
                        }
                        n = int(tok[3])
                        tname = tok[5]
                        tid = next(
                            t for t, nm in m.type_names.items() if nm == tname
                        )
                        cur_rule.steps.append(RuleStep(ops[op], n, tid))
                elif tok[0] == "}":
                    cur_rule = None
            elif cur_bucket is not None:
                if tok[0] == "id":
                    cur_bucket.id = int(tok[1])
                elif tok[0] == "alg":
                    by_name = {v: k for k, v in BUCKET_ALG_NAMES.items()}
                    if tok[1] not in by_name:
                        raise ValueError(f"bucket alg {tok[1]!r} unknown")
                    cur_bucket.alg = by_name[tok[1]]
                elif tok[0] == "hash":
                    cur_bucket.hash_id = int(tok[1])
                elif tok[0] == "item":
                    pending_items.append((tok[1], float(tok[3])))
                elif tok[0] == "}":
                    tname, bname = bucket_header
                    cur_bucket.type = next(
                        t for t, nm in m.type_names.items() if nm == tname
                    )
                    for iname, wf in pending_items:
                        cur_bucket.items.append(resolve(iname))
                        cur_bucket.weights.append(int(round(wf * 0x10000)))
                    # legacy aux tables are BUILD-time artifacts: derive
                    # them on ingest exactly as the builder does — and
                    # apply the builder's validation so the same invalid
                    # map is rejected regardless of entry point
                    if (
                        cur_bucket.alg == BUCKET_UNIFORM
                        and len(set(cur_bucket.weights)) > 1
                    ):
                        raise ValueError(
                            f"uniform bucket {bname!r} has unequal item "
                            f"weights"
                        )
                    if cur_bucket.alg == BUCKET_STRAW:
                        from .builder import calc_straws

                        cur_bucket.straws = calc_straws(cur_bucket.weights)
                    elif cur_bucket.alg == BUCKET_TREE:
                        from .builder import calc_tree_nodes

                        cur_bucket.node_weights = calc_tree_nodes(
                            cur_bucket.weights)
                    m.buckets[cur_bucket.id] = cur_bucket
                    m.bucket_names[cur_bucket.id] = bname
                    names_to_resolve[bname] = cur_bucket.id
                    cur_bucket = None
            elif cur_choose_args is not None:
                if tok[0] == "bucket":
                    bid = int(tok[1])
                    rows = " ".join(tok[3:])
                    weight_set = [
                        [
                            int(round(float(v) * 0x10000))
                            for v in row.split()
                        ]
                        for row in rows.replace("[", " ").split("]")
                        if row.strip()
                    ]
                    m.choose_args.setdefault(cur_choose_args, {})[bid] = (
                        weight_set
                    )
                elif tok[0] == "}":
                    cur_choose_args = None
            elif tok[0] == "tunable":
                setattr(m.tunables, tok[1], int(tok[2]))
            elif tok[0] == "device":
                did = int(tok[1])
                m.max_devices = max(m.max_devices, did + 1)
                if tok[2] != f"osd.{did}":
                    m.device_names[did] = tok[2]
                if len(tok) >= 5 and tok[3] == "class":
                    m.device_classes[did] = w.class_id(tok[4], create=True)
            elif tok[0] == "choose_args":
                cur_choose_args = tok[1]
            elif tok[0] == "type":
                m.type_names[int(tok[1])] = tok[2]
            elif tok[0] == "class":
                m.class_names[int(tok[1])] = tok[2]
            elif tok[0] == "rule":
                cur_rule = Rule(rule_id=-1)
            elif tok[-1] == "{":
                bucket_header = (tok[0], tok[1])
                pending_items = []
                cur_bucket = Straw2Bucket(id=0, type=0)
        if 0 not in m.type_names:
            m.type_names[0] = "osd"
        if m.class_names:
            w.populate_classes()
        for step, root_name, cls_name in pending_class_takes:
            step.arg1 = w.shadow_root(
                names_to_resolve[root_name], cls_name
            )
        return w
