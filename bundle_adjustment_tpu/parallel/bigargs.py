"""Pass large arrays as jit arguments instead of closure constants.

Closing over device arrays embeds them as constants in the lowered program:
hundreds of MB of literals in the HLO, which the compiler hashes, copies
and may try to constant-fold, and which tie the persistent-cache key to
the data.  These helpers split a NamedTuple's big fields out so they
travel as arguments:

    names, big = split_big(fmp)
    f = jax.jit(lambda big_, x: work(merge(fmp, names, big_), x))
    f(big, x)
"""

from __future__ import annotations

import jax

#: fields whose leaves total more than this many bytes become arguments
THRESHOLD = 1 << 20


def _field_bytes(v) -> int:
    return sum(getattr(l, "nbytes", 0) for l in jax.tree.leaves(v))


def split_big(nt, threshold: int = THRESHOLD):
    """Returns (names, values) of the NamedTuple fields worth passing as
    arguments (tree-aware: fields may be tuples of arrays).  Index arrays
    travel too: a gather whose indices are constants is folded at compile
    time, and folding a million-row gather takes the compiler seconds."""
    names = tuple(f for f in nt._fields
                  if _field_bytes(getattr(nt, f)) > threshold)
    return names, tuple(getattr(nt, f) for f in names)


def merge(nt, names, values):
    """Rebuild the NamedTuple with the (possibly traced) big fields."""
    return nt._replace(**dict(zip(names, values)))
