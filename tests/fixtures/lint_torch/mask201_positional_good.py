"""Fixture: the port's positional forward of the lane mask: the bare name
``active`` as a positional argument of a call (``autograd.Function.apply``
takes no keywords)."""


class _Attention:
    @staticmethod
    def apply(q, k, v, active, causal):
        return q


def _lane_predicate(active, like):
    return active


def packed_unused(x, *, active=None):
    return _Attention.apply(x, x, x, _lane_predicate(active, x), True)


def packed_assigned(x, *, active=None):
    return _Attention.apply(x, x, x, active, True)


def packed_expression(x, *, active=None):
    return _lane_predicate(active, x) * x
