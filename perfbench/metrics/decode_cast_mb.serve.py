"""The program's ``cast_bytes`` counter over each ``serve.decode_step``
span and the spans below it (the bytes of weights read by casts to the
compute dtype), the median over the traced window's decode steps, in MB
(1e6 bytes)."""
import statistics

from perfbench.metrics._spans import counted_under, record


def read(ctx):
    per_step = counted_under(record(), "serve.decode_step", "cast_bytes")
    return statistics.median(per_step) / 1e6 if per_step else None
