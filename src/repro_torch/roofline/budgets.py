"""Per-kernel resource budgets of the port's CUDA kernels (the counterpart of
the reference's ``PALLAS_TILE_BUDGETS`` and ``PALLAS_NOMINAL_DIMS`` in
``roofline/hlo_costs.py``), read by the contract lint (CUD406) and by
``analysis.kernel_report --check --libs``.

Keyed ``relpath::kernel`` (the ``__global__`` function's name), each entry
holds

  * ``smem_bytes``: shared memory per CTA at the nominal dims, static
    arrays plus the launch's dynamic size, as the kernel model computes it
    from the tile constants (``analysis.cuda_model``). CUD406 fails when
    an edit moves the modelled size more than ``SMEM_TOLERANCE`` from it;
  * ``nominal``: the names of the launching function that are not
    constants (template parameters, a runtime plan), bound to a value or
    to the text of an expression or type. Values follow the main path's
    shapes: head dim 128, the f32 B1 tile, bf16 rows of 8 vectors a lane,
    mamba2-130m's prefill of 1,024 tokens in chunks of 128 (24 heads,
    head dim 64, state 128) in bf16;
  * ``registers``: the ceiling per thread at launch. The wgmma bodies
    launch with 168, the figure their ``setmaxnreg`` split of 384 threads
    is written for; every other ceiling is the largest reading of any
    instantiation in ``cuobjdump --dump-resource-usage`` of the libraries
    built for sm_90a on an NVIDIA H100 80GB HBM3 (700 W, CUDA 12.8),
    rounded up to the allocation granule of 8 registers;
  * ``local_bytes``: the local memory (a stack frame) an instantiation may
    use. A local array is not a spill; ``spill_bytes`` is budgeted apart
    and is 0 everywhere.
"""
from __future__ import annotations

from typing import Dict

#: Allowed relative drift between the modelled shared memory and its budget.
SMEM_TOLERANCE = 0.25

#: The runtime's shared memory reserved per CTA on sm_90 in a module whose
#: kernels use shared memory (``cuobjdump`` counts it in SHARED).
RESERVED_SMEM = 1024

_PLAN = "make_plan(1, 1024, 24, 64, 128, 128, 1)"
_CSRC = "src/repro_torch/kernels/csrc/"

KERNEL_BUDGETS: Dict[str, Dict] = {
    _CSRC + "flash_attention.cu::fa_fwd_simt_kernel": dict(
        smem_bytes=115712, nominal={"D": 128}, registers=128,
        local_bytes=0, spill_bytes=0),
    _CSRC + "flash_attention.cu::fa_fwd_wgmma_kernel": dict(
        smem_bytes=164904, nominal={"D": 128}, registers=168,
        local_bytes=0, spill_bytes=0),
    _CSRC + "packed_gemm.cu::gemm_simt_kernel": dict(
        smem_bytes=25600, nominal={}, registers=152,
        local_bytes=0, spill_bytes=0),
    _CSRC + "packed_gemm.cu::gemm_wgmma_kernel": dict(
        smem_bytes=197696, nominal={"TA": 0}, registers=168,
        local_bytes=0, spill_bytes=0),
    _CSRC + "rmsnorm.cu::fused_rmsnorm_kernel": dict(
        smem_bytes=0, nominal={"T": "__nv_bfloat16", "VPL": 8},
        registers=160, local_bytes=0, spill_bytes=0),
    _CSRC + "rmsnorm.cu::packed_rmsnorm_kernel": dict(
        smem_bytes=0, nominal={"T": "__nv_bfloat16", "VPL": 8},
        registers=160, local_bytes=0, spill_bytes=0),
    _CSRC + "ssd_scan.cu::ssd_chunk_kernel": dict(
        smem_bytes=109568,
        nominal={"T": "__nv_bfloat16", "P": 1, "pl": _PLAN},
        registers=96, local_bytes=0, spill_bytes=0),
    _CSRC + "ssd_scan.cu::ssd_state_kernel": dict(
        smem_bytes=0, nominal={"pl": _PLAN}, registers=32, local_bytes=0,
        spill_bytes=0),
    _CSRC + "ssd_scan.cu::ssd_out_kernel": dict(
        smem_bytes=109568,
        nominal={"T": "__nv_bfloat16", "P": 1, "pl": _PLAN},
        registers=104, local_bytes=0, spill_bytes=0),
}
