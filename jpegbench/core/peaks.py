"""The yardstick of rooflines: the published peaks of one NVIDIA H100 SXM
(dense, no sparsity, at its full 700 W), and the least time a piece of
work can take on it.

A bound counts the work a stage must do at the interface's dtypes: each
input byte read once, each output byte written once, the matrix product
at the tensor cores' bf16 rate and the per-element operations at the CUDA
cores' float32 rate. It never counts what one implementation happens to
touch, so a fused, re-typed or removed kernel is held to the same work."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TENSOR_FLOPS_PER_S = 989e12  # bf16, dense
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, mma_flops: float = 0.0, other_ops: float = 0.0) -> float:
    """The least seconds for work that moves ``n_bytes`` to or from device
    memory, does ``mma_flops`` of matrix product and ``other_ops``
    per-element operations: the larger of the memory time and the compute
    time."""
    return max(n_bytes / HBM_BYTES_PER_S,
               mma_flops / TENSOR_FLOPS_PER_S + other_ops / FP32_OPS_PER_S)
