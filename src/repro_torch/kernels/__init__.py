"""Hand-written CUDA kernels for Hopper, their wrappers, plain versions and
plans. Importing this package builds nothing: a kernel is compiled at its
first launch (:mod:`repro_torch.kernels._build`)."""


def wrappers() -> dict:
    """The fourteen kernel wrappers by name: one for each TPU kernel of the
    reference, then the GAN projection's forward, dW and dz, which replace
    per-row library calls (:mod:`repro_torch.kernels.project`), and the RGB
    head's forward, dx and dW (:mod:`repro_torch.kernels.rgb_head`). Each
    counts its kernel's launches in ``.launches``; those with a second pass
    (split sums, the decode combine, the head's dW partials) count it apart
    in ``.reduce_launches``. A CUDA graph's replay adds the launches it
    captured (:mod:`repro_torch.graphs`)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.project import (
        project_relu_dw,
        project_relu_dz,
        project_relu_fwd,
    )
    from repro_torch.kernels.rgb_head import rgb_head_dw, rgb_head_dx, rgb_head_fwd
    from repro_torch.kernels.transpose_conv2d import (
        transpose_conv2d_fused,
        transpose_conv2d_phase,
    )
    from repro_torch.kernels.transpose_conv2d_bwd import (
        epilogue_grad,
        transpose_conv2d_dw,
        transpose_conv2d_dx,
    )
    from repro_torch.kernels.transpose_conv2d_gemm import transpose_conv2d_gemm
    from repro_torch.kernels.transpose_conv2d_pair import transpose_conv2d_pair

    return {
        "fused": transpose_conv2d_fused,
        "gemm": transpose_conv2d_gemm,
        "pair": transpose_conv2d_pair,
        "phase": transpose_conv2d_phase,
        "epilogue_grad": epilogue_grad,
        "dx": transpose_conv2d_dx,
        "dw": transpose_conv2d_dw,
        "decode_attention": decode_attention,
        "project": project_relu_fwd,
        "project_dw": project_relu_dw,
        "project_dz": project_relu_dz,
        "rgb_head": rgb_head_fwd,
        "rgb_head_dx": rgb_head_dx,
        "rgb_head_dw": rgb_head_dw,
    }
