"""FROZEN golden oracle — NumPy per-scanline reference (SURVEY.md §4.2).

The port's copy of ``color_modem_tpu/golden/``, so that the card, where the
JAX package is not installed, is held to the same oracle
(``chip_smoke.py`` phase 4k).  It takes the port's plans and imports the
port's host modules only (the standards, the decoder registry,
``dsp/design.py::resample_matrix``, ``modem/mac_plan.py``); its outputs
equal the JAX package's oracle bit for bit (``tests/test_torch_golden.py``).
No JAX imports, and no torch arithmetic, anywhere in this package.
"""

from color_modem_tpu_torch.golden.frame import (  # noqa: F401
    FM_DECODERS,
    QAM_DECODERS,
    allowed_decoders,
    comb_spacing,
    decode_frame,
    decode_sequence,
    encode_frame,
)
from color_modem_tpu_torch.golden.modems import (  # noqa: F401
    GoldenQamModem,
    GoldenSecamModem,
    host_plan,
)
