"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and their
plain PyTorch versions.  Nothing here builds or imports a compiler at
import time: ``build.load_library`` compiles at the first launch."""


def launch_counts() -> dict:
    """A copy of every kernel's launch counter (``qam.LAUNCHES``,
    ``secam.LAUNCHES``, ``prng.LAUNCHES``, ``colorimetry.LAUNCHES`` and
    ``comb.LAUNCHES``)."""
    from color_modem_tpu_torch.kernels import colorimetry, comb, prng, qam, secam

    return {**qam.LAUNCHES, **secam.LAUNCHES, **prng.LAUNCHES, **colorimetry.LAUNCHES,
            **comb.LAUNCHES}


def reset_launches() -> None:
    """Zero every kernel's launch counter."""
    from color_modem_tpu_torch.kernels import colorimetry, comb, prng, qam, secam

    qam.reset_launches()
    secam.reset_launches()
    prng.reset_launches()
    colorimetry.reset_launches()
    comb.reset_launches()
