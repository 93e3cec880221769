"""Hand-written CUDA kernels for Hopper (``csrc/``) and their wrappers; the
plain versions a wrapper runs on a CPU tensor live in the layers below.
Nothing here builds or imports a compiler at import time:
``build.load_library`` compiles at the first launch."""

from color_modem_tpu_torch.kernels.build import LAUNCHES


def launch_counts() -> dict:
    """A copy of the launch counter, one key per CUDA entry point
    (``build.LAUNCHES``)."""
    return dict(LAUNCHES)


def reset_launches() -> None:
    """Zero every entry point's launch count."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
