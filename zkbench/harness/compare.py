"""The comparison that decides ``correct``: values the program produced against
the values the plain reference works out, position by position."""

from __future__ import annotations


def mismatches(got, want) -> int:
    """How many values differ between two nested dicts, lists or tuples of
    ints (a point is a pair of coordinates, ``None`` the point at infinity).
    A value missing on either side counts as one that differs."""
    if isinstance(got, dict) and isinstance(want, dict):
        keys = set(got) | set(want)
        return sum(mismatches(got.get(k), want.get(k)) if k in got and k in want else 1
                   for k in keys)
    if isinstance(got, (list, tuple)) and isinstance(want, (list, tuple)):
        return abs(len(got) - len(want)) + sum(mismatches(a, b) for a, b in zip(got, want))
    return int(got != want)
