"""The distributed layer (port of ``repro.distributed``): sharding rules as
DTensor placements on a ``DeviceMesh``, gradient compression on
``torch.distributed`` process groups, and the ring collective matmul."""
from repro_torch.distributed.sharding import (  # noqa: F401
    param_shardings, batch_shardings, fsdp_axes_of, ShardingRules)
from repro_torch.distributed.compression import (  # noqa: F401
    quantize_int8, dequantize_int8, ErrorFeedback, compressed_psum)
