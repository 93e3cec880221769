"""color_modem_tpu_torch — the analog colour-TV modem in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of :mod:`color_modem_tpu` (JAX/Pallas on a TPU), which stays the
reference.  This package imports ``torch`` and never ``jax``, nor any module
of the JAX package: it keeps its own copies of the NumPy-only tables it
needs (``standards/``, ``utils.testimages.smooth_scene``), held equal to the
JAX ones by ``tests/test_torch_standards.py``.

Layout mirrors the JAX package:

- ``standards/`` the frozen standard configurations and the decoder registry
- ``dsp/``       host FIR design (NumPy f64), the int32 NCO phase law,
                 colorimetry, the plain Toeplitz FIRs (zero and held edges)
- ``modem/``     ``QamPlan`` and ``FmPlan`` (``nn.Module``s of float32
                 buffers), the plain QAM and SECAM modem functions and
                 NIIR reference normalisation
- ``separate/``  line and frame stencils, the notch, line, temporal and
                 adaptive combs, and chroma averaging
- ``kernels/``   wrappers of the CUDA kernels in ``csrc/``, each with its
                 plain PyTorch version and a launch counter; ``build.py``
                 compiles ``csrc/*.cu`` with ``nvcc`` at first use
- ``frame/``     the batched RGB <-> composite pipeline, the sync/burst
                 raster with burst lock and PAL ident, and the channel
                 impairments

Public layouts match the JAX package: RGB ``(B, 3, L, N)``, composite
``(B, L, N)``, absolute line indices ``(B, L)`` int32.  The plain versions
assume float32 matrix products (PyTorch's default; TF32 off).
"""

__version__ = "0.1.0"

from color_modem_tpu_torch.standards import (  # noqa: F401
    ALL_STANDARDS,
    NIIR,
    NTSC,
    NTSC443,
    PAL,
    PAL60,
    PAL_M,
    PAL_N,
    SECAM,
)
