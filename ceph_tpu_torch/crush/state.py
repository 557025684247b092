"""State carried across from the JAX package: the CRUSH map.

For placement the state is the map, its choose_args weight-sets and the
reweight vector.  ``wrapper_from_reference`` builds the port's
CrushWrapper from the reference's ``format_text()`` and its
``cmap.choose_args`` (name -> bucket id -> weight_set rows of 16.16
ints).  The text form prints weight-sets with five decimals, which does
not keep every 16.16 weight, so the exact rows come beside it.  The
reweight vector is a plain array the caller passes to each mapping.
"""
from __future__ import annotations

from .wrapper import CrushWrapper


def wrapper_from_reference(text: str, choose_args: dict | None = None) -> CrushWrapper:
    """The port's CrushWrapper for a map in the reference's text form,
    with the given weight-sets in place of the text's rounded ones."""
    w = CrushWrapper.parse_text(text)
    if choose_args is not None:
        w.map.choose_args = {
            str(name): {int(bid): [[int(v) for v in row] for row in ws]
                        for bid, ws in sets.items()}
            for name, sets in choose_args.items()
        }
        w.invalidate()
    return w
