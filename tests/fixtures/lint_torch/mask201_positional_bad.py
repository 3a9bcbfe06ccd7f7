"""Fixture: entrypoints that take ``active`` and do not forward it
(MASK201 three times)."""


def packed_unused(x, *, active=None):      # MASK201: never read
    return x * 2


def packed_assigned(x, *, active=None):    # MASK201: read, not forwarded
    mask = active
    return x * 2


def packed_expression(x, *, active=None):  # MASK201: read in arithmetic
    return x * (active + 0)
