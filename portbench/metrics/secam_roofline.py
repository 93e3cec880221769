"""The SECAM kernels' share of their roofline: the sum of
``secam_encode``'s and ``secam_decode``'s least times
(``portbench/work.py``) over the device time per call of the kernels named
``secam_encode_*`` and ``secam_decode_*`` (``_kernel``, ``_pipe``), in per
cent.  Layer: kernels (``kernels/secam.py`` -> ``csrc/secam_*.cu``)."""

from portbench import kernel_share


def read(record):
    return kernel_share.read(record, {
        "secam_encode": ("secam_encode_kernel", "secam_encode_pipe"),
        "secam_decode": ("secam_decode_kernel", "secam_decode_pipe")})
