"""Core: the paper's contribution, unified kernel-segregated transpose
convolution. Mirrors ``repro/core/__init__.py`` and exports its names."""
from repro_torch.core.segregation import (
    SubKernels,
    segregate_kernel,
    merge_subkernels,
    stack_subkernels,
    flop_count,
    memory_savings_bytes,
    output_size,
)
from repro_torch.core.transpose_conv import (
    transpose_conv2d,
    transpose_conv_conventional,
    transpose_conv_unified,
    transpose_conv_grouped,
    transpose_conv_xla,
    upsample_bed_of_nails,
)
from repro_torch.core.dilated_conv import dilated_conv2d

__all__ = [
    "SubKernels",
    "segregate_kernel",
    "merge_subkernels",
    "stack_subkernels",
    "flop_count",
    "memory_savings_bytes",
    "output_size",
    "transpose_conv2d",
    "transpose_conv_conventional",
    "transpose_conv_unified",
    "transpose_conv_grouped",
    "transpose_conv_xla",
    "upsample_bed_of_nails",
    "dilated_conv2d",
]
