"""color_modem_tpu_torch — the analog colour-TV modem in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of :mod:`color_modem_tpu` (JAX/Pallas on a TPU), which stays the
reference.  This package imports ``torch`` and never ``jax``, nor any module
of the JAX package: it keeps its own copies of the NumPy-only tables it
needs (``standards/``, ``utils/testimages.py``), held equal to the JAX ones
by ``tests/test_torch_standards.py`` and ``tests/test_torch_testimages.py``.

One call builds a pipeline by the standard's name::

    import color_modem_tpu_torch as cmt
    encode, decode, roundtrip = cmt.make_pipeline("pal", decoder="delayline")

Layout mirrors the JAX package:

- ``standards/`` the frozen standard configurations and the decoder registry
- ``dsp/``       host FIR design (NumPy f64), the int32 NCO phase law,
                 colorimetry, the plain Toeplitz FIRs (zero and held edges),
                 the overlap-save stream engine, the resampler
- ``modem/``     ``QamPlan`` and ``FmPlan`` (``nn.Module``s of float32
                 buffers), the plain QAM and SECAM modem functions, NIIR
                 reference normalisation, D2-MAC and D-MAC
- ``separate/``  line and frame stencils, the notch, line, temporal and
                 adaptive combs, and chroma averaging
- ``kernels/``   wrappers of the CUDA kernels in ``csrc/``, each with its
                 plain PyTorch version and a launch counter; ``build.py``
                 compiles ``csrc/*.cu`` with ``nvcc`` at first use;
                 ``measure.py`` the kernels' bounds and CUDA-event timing
- ``frame/``     the batched RGB <-> composite pipeline; the raster with
                 burst lock and PAL ident, the channel impairments;
                 interlace, S-Video, transcoding, NR, deinterlacing and
                 telecine; the chunked, resumable video runner; the RF/VSB
                 and satellite-FM hops, the GCR equalizer and the TBC; the
                 sound layer (FM, MTS, NICAM-728, A2); the data services
                 (captions, teletext, WSS, VITC, VIR), the instruments,
                 scrambling and PALplus; Y4M and image I/O
- ``parallel/``  the (frame, lineblk) rank mesh on ``torch.distributed``,
                 ring halos, the sharded pipelines and the rank launcher
- ``native/``    the g++-built host frame codec (with its NumPy path)
- ``compat/``    the reference-style per-line ``modulate``/``demodulate`` API
- ``utils/``     metrics, the test images, manifests, WAV I/O, the float
                 sanitizer and the profiling helpers
- ``cli.py``     the command line (``python -m color_modem_tpu_torch.cli``);
  ``benchmark.py`` the one-card round-trip benchmark; ``entry.py`` the
  compile-check and multi-rank dry-run entry points

Public layouts match the JAX package: RGB ``(B, 3, L, N)``, composite
``(B, L, N)``, absolute line indices ``(B, L)`` int32.  Every factory runs
on the card (``device="cuda"``) unless given ``device="cpu"``; float32
products run with TF32 off whatever the process-wide setting.
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


def make_pipeline(standard: str, samples: int = 720, decoder: str = "notch",
                  backend: str = "kernel", raster: bool = False, device="cuda"):
    """One-call convenience: ``(encode, decode, roundtrip)`` for a standard.

        import color_modem_tpu_torch as cmt
        encode, decode, roundtrip = cmt.make_pipeline("pal", decoder="delayline")

    For full control build a plan explicitly (``modem.plan.make_plan``) and
    use ``frame.pipeline.make_pipeline`` or ``parallel.make_sharded_pipeline``.
    """
    from color_modem_tpu_torch.frame.pipeline import make_pipeline as _mk
    from color_modem_tpu_torch.modem.plan import make_plan

    plan = make_plan(ALL_STANDARDS[standard](), samples)
    return _mk(plan, decoder, backend, device, raster=raster)


def make_interlaced_pipeline(standard: str, samples: int = 720, decoder: str = "notch",
                             backend: str = "kernel", device="cuda"):
    """Like :func:`make_pipeline`, transmitting 2:1 interlaced fields
    (``frame.interlace``): RGB frames <-> field-sequential composite."""
    from color_modem_tpu_torch.frame.interlace import make_interlaced_pipeline as _mk
    from color_modem_tpu_torch.modem.plan import make_plan

    plan = make_plan(ALL_STANDARDS[standard](), samples)
    return _mk(plan, decoder, backend, device)


def make_svideo_pipeline(standard: str, samples: int = 720, backend: str = "kernel",
                         device="cuda"):
    """Like :func:`make_pipeline` over separate Y/C planes (``frame.svideo``):
    no shared wire, hence no separation stage and no cross-colour."""
    from color_modem_tpu_torch.frame.svideo import make_svideo_pipeline as _mk
    from color_modem_tpu_torch.modem.plan import make_plan

    plan = make_plan(ALL_STANDARDS[standard](), samples)
    return _mk(plan, backend, device)


def make_transcoder(src: str, dst: str, samples: int = 720, decoder: str | None = None,
                    backend: str = "kernel", device="cuda"):
    """Standards converter by name (``frame.transcode``):
    ``conv = cmt.make_transcoder("ntsc", "pal"); pal = conv(ntsc_comp)``."""
    from color_modem_tpu_torch.frame.transcode import make_transcoder as _mk
    from color_modem_tpu_torch.modem.plan import make_plan

    return _mk(make_plan(ALL_STANDARDS[src](), samples),
               make_plan(ALL_STANDARDS[dst](), samples), decoder, backend, device)
