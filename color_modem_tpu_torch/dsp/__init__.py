"""DSP layer: host FIR design, the closed-form NCO, FIR application and
colorimetry.

Importing it (every module of the port that computes does) first runs each
float32 and float64 function that PyTorch computes through MKL's vector
math library once on a one-element CPU tensor: see :func:`_warm_vml`."""

import torch

#: PyTorch's CPU functions that call MKL's vector math library (``vml.h``)
_VML_FUNCTIONS = ("sin", "cos", "tan", "asin", "acos", "atan", "exp", "expm1", "log",
                  "log10", "log1p", "log2", "sqrt", "tanh", "erf", "erfc", "erfinv")


def _warm_vml() -> None:
    """Call each of :data:`_VML_FUNCTIONS` once on one element, so on the
    calling thread alone.  On an NVIDIA H100 host's CPU (AVX512; PyTorch
    2.11, MKL 2024.2, 8 threads) the first ``torch.sin`` of a process, when
    it ran on several threads at once, returned about one thread's share of
    a (2, 64, 720) float32 tensor up to 1.5e-4 off, in 1 of 18 fresh
    processes (``scripts/torch_encode_first_call.py``); every later call
    was exact to float32.  The plain versions the kernels are held against
    must not depend on which call of the process they are."""
    for dtype in (torch.float32, torch.float64):
        x = torch.full((1,), 0.5, dtype=dtype)
        for name in _VML_FUNCTIONS:
            getattr(torch, name)(x)


_warm_vml()
