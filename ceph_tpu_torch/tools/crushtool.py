"""crushtool analog — compile/decompile/test CRUSH maps from the shell.

The port's counterpart of ceph_tpu/tools/crushtool.py, with the same
options and output lines; --test maps on the card unless given
``--device cpu``.

Reference: src/tools/crushtool.cc (CLI surface) + src/crush/CrushTester.cc
(--test: map a range of x values through a rule and report mappings and
per-device utilization — the reference's own "batch CRUSH" consumer and the
golden-output oracle of its cram tests, src/test/cli/crushtool/*.t).

The map file format is the text grammar of CrushWrapper.format_text (the
CrushCompiler analog); --test runs the batched mapper, so this tool is
also the quickest way to eyeball crush_do_rule_batch against a real map.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..crush import CrushWrapper, ITEM_NONE, build_hierarchical_map


def _load(path: str) -> CrushWrapper:
    with open(path) as f:
        return CrushWrapper.parse_text(f.read())


def run_test(
    w: CrushWrapper,
    rules: list[int],
    num_rep: int,
    min_x: int,
    max_x: int,
    show_mappings: bool,
    show_utilization: bool,
    show_bad_mappings: bool,
    weights: np.ndarray,
    out=sys.stdout,
    device=None,
) -> None:
    """CrushTester::test analog; output format mirrors the reference's
    `CRUSH rule R x X [osds]` / `device N: stored : S expected : E` lines.
    The mappings run on `device` (``cuda`` unless given ``"cpu"``)."""
    xs = np.arange(min_x, max_x + 1, dtype=np.int64)
    for rid in rules:
        got = w.do_rule_batch(rid, xs, num_rep, weights, device=device).cpu().numpy()
        if show_mappings:
            for x, row in zip(xs, got):
                osds = [int(o) for o in row if o != ITEM_NONE]
                print(f"CRUSH rule {rid} x {int(x)} {osds}", file=out)
        if show_bad_mappings:
            for x, row in zip(xs, got):
                osds = [int(o) for o in row if o != ITEM_NONE]
                if len(osds) != num_rep:
                    print(
                        f"bad mapping rule {rid} x {int(x)} num_rep "
                        f"{num_rep} result {osds}",
                        file=out,
                    )
        if show_utilization:
            n_objects = len(xs)
            placed = got[got != ITEM_NONE]
            devs, counts = np.unique(placed, return_counts=True)
            sizes = (got != ITEM_NONE).sum(axis=1)
            for size in range(num_rep + 1):
                n = int((sizes == size).sum())
                if n:
                    print(
                        f"rule {rid} ({w.map.rules[rid].rule_id}) num_rep "
                        f"{num_rep} result size == {size}:\t{n}/{n_objects}",
                        file=out,
                    )
            # expected share uses the rule's reachable subtree only (a
            # class rule must not count other classes' devices), scaled by
            # the reweight vector as CRUSH itself applies it
            rule_w = w.get_rule_weight_osd_map(rid)
            eff = {
                d: cw * weights[d] / 0x10000 for d, cw in rule_w.items()
            }
            total_w = sum(eff.values())
            for d, c in zip(devs, counts):
                exp = (
                    len(placed) * eff.get(int(d), 0.0) / total_w
                    if total_w
                    else 0.0
                )
                print(
                    f"  device {int(d)}:\t stored : {int(c)}\t expected : "
                    f"{exp:.2f}",
                    file=out,
                )


def main(argv=None, out=sys.stdout) -> int:
    ap = argparse.ArgumentParser(
        prog="crushtool", description=__doc__.splitlines()[0]
    )
    ap.add_argument("-i", "--infn", help="input map (text form)")
    ap.add_argument("-o", "--outfn", help="output file")
    ap.add_argument(
        "-d", "--decompile", action="store_true",
        help="print the map in text form (canonicalized)",
    )
    ap.add_argument(
        "-c", "--compile", dest="compile_", action="store_true",
        help="parse and re-emit the map (validates the grammar)",
    )
    ap.add_argument(
        "--build", nargs=2, type=int, metavar=("HOSTS", "OSDS_PER_HOST"),
        help="build a root/host/osd test map (crushtool --build analog)",
    )
    ap.add_argument("--test", action="store_true", help="run CrushTester")
    ap.add_argument("--rule", type=int, action="append", default=None)
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--min-x", type=int, default=0)
    ap.add_argument("--max-x", type=int, default=1023)
    ap.add_argument("--show-mappings", action="store_true")
    ap.add_argument("--show-utilization", action="store_true")
    ap.add_argument("--show-bad-mappings", action="store_true")
    ap.add_argument(
        "--weight", nargs=2, action="append", default=[],
        metavar=("OSD", "WEIGHT"),
        help="override an osd reweight for --test (0.0..1.0)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device --test maps on (default cuda; cpu runs the "
             "kernels' plain versions)",
    )
    args = ap.parse_args(argv)

    if args.build:
        w = CrushWrapper(build_hierarchical_map(*args.build))
    elif args.infn:
        w = _load(args.infn)
    else:
        print("crushtool: no input map (-i or --build)", file=sys.stderr)
        return 1

    if args.decompile or args.compile_:
        text = w.format_text()
        if args.outfn:
            with open(args.outfn, "w") as f:
                f.write(text)
        else:
            out.write(text)

    if args.test:
        weights = np.full(w.map.max_devices, 0x10000, dtype=np.int64)
        for osd, wt in args.weight:
            try:
                osd_id, value = int(osd), float(wt)
            except ValueError:
                print(f"crushtool: bad --weight {osd} {wt}", file=sys.stderr)
                return 1
            if not 0 <= osd_id < w.map.max_devices:
                print(
                    f"crushtool: --weight osd.{osd_id} out of range "
                    f"(map has max_devices {w.map.max_devices})",
                    file=sys.stderr,
                )
                return 1
            weights[osd_id] = int(value * 0x10000)
        rules = args.rule if args.rule else sorted(w.map.rules)
        run_test(
            w,
            rules,
            args.num_rep,
            args.min_x,
            args.max_x,
            args.show_mappings,
            args.show_utilization,
            args.show_bad_mappings,
            weights,
            out=out,
            device=args.device,
        )
    elif args.build and not (args.decompile or args.compile_):
        # --build with no other action emits the built map (to -o or stdout)
        if args.outfn:
            with open(args.outfn, "w") as f:
                f.write(w.format_text())
        else:
            out.write(w.format_text())
    elif not (args.decompile or args.compile_):
        ap.print_usage(file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `crushtool ... | head`
        sys.exit(141)
