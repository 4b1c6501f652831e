"""The convolution kernels of a profiled stretch, found by name.

cuDNN picks a convolution's algorithm by shape, and each algorithm runs
kernels of its own: direct engines, implicit GEMMs, Winograd and FFT
(whose transforms, complex GEMMs and products are separate launches),
with layout transforms and scalings around them. A traced run of
``conv4.train`` on an H100 (torch 2.11, cuDNN 9.22) ran, per kernel name,
``dgrad_engine``, ``wgrad_alg0_engine_NHWC``,
``convolve_common_engine_float_NHWC``, ``sm80_xmma_fprop_implicit_gemm``,
``winograd_nonfused::winogradWgrad*``, ``fft2d_r2c_*``/``fft2d_c2r_*``,
``flip_filter``, ``pointwise_mult_and_sum_complex``,
``internal::region_transform_ABC_val`` (on complex data),
``sm80_xmma_gemm_cf32cf32`` (complex), ``nhwcToNchwKernel``,
``nchwToNhwcKernel``, ``nhwcSliceCKernel``, ``scalePackedTensor_kernel``
and ``scaleTensor_kernel``: ``PARTS`` matches each of them and nothing
else of that step (the port's norm is written out, so cuDNN runs only
convolutions there; cuBLAS's real GEMMs of the head match none).
"""

from __future__ import annotations

from typing import Optional

from benchmark import stats

PARTS = ("cudnn", "fprop", "dgrad", "wgrad", "convolve", "winograd", "fft2d",
         "flip_filter", "pointwise_mult_and_sum_complex", "region_transform",
         "gemm_cf32")


def conv_busy_s(tr) -> Optional[float]:
    """Seconds of the stretch in which a device operation whose name holds
    one of ``PARTS`` ran (their union); None where the stretch ran none."""
    if tr is None:
        return None
    spans = [(e.start, e.end) for e in tr.device
             if any(p in e.name for p in PARTS)]
    if not spans:
        return None
    return stats.covered(spans, tr.lo, tr.hi) / 1e6
