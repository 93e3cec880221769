"""Reference-compatible per-line API (port of ``color_modem_tpu/compat``)."""

from color_modem_tpu_torch.compat.line_api import (  # noqa: F401
    ColorAveragingModem,
    DelayLinePalModem,
    ImageModem,
    NiirModem,
    NtscModem,
    PalModem,
    SecamModem,
    Simple3DCombModem,
    SimpleCombModem,
    make_line_modem,
)
