"""What a TMA tensor map can describe, decided on the host from shapes,
strides and addresses alone (the rules of ``cuTensorMapEncodeTiled`` that
``csrc/tma.cuh`` encodes with): a 16-byte aligned base, a contiguous
innermost axis, and on every other axis longer than 1 a positive stride of
a multiple of 16 bytes. The tensor-core bodies of the packed GEMM and flash
attention read their operands through such maps."""
from __future__ import annotations

ALIGN = 16      # bytes: the base and every stride but the innermost
MULTIPLE = 8    # elements: a padded row, and a stride no address uses


def describable(shape, stride, inner: int, data_ptr: int,
                itemsize: int) -> bool:
    """Whether a map can read a tensor whose axis ``inner`` is contiguous."""
    if stride[inner] != 1 or data_ptr % ALIGN:
        return False
    return all(n == 1 or (st > 0 and st * itemsize % ALIGN == 0)
               for a, (n, st) in enumerate(zip(shape, stride)) if a != inner)


def map_strides(shape, stride) -> tuple:
    """``stride`` with the stride of each axis of length 1 (which no address
    uses) replaced by the tensor's span rounded up to a multiple of 8
    elements, so an encode accepts it."""
    span = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    span = -(-span // MULTIPLE) * MULTIPLE
    return tuple(span if n == 1 else st for n, st in zip(shape, stride))
