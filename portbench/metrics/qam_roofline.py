"""The QAM kernels' share of their roofline: the sum of ``qam_encode``'s and
``qam_decode``'s least times (``portbench/work.py``) over the device time
per call of the kernels named ``qam_encode_kernel`` and
``qam_decode_kernel``, in per cent.  Layer: kernels (``kernels/qam.py`` ->
``csrc/qam_*.cu``)."""

from portbench import kernel_share


def read(record):
    return kernel_share.read(record, {"qam_encode": ("qam_encode_kernel",),
                                      "qam_decode": ("qam_decode_kernel",)})
