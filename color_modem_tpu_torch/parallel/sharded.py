"""Sharded frame pipelines: DP over frames x CP over line blocks, one rank
per block.

Port of ``color_modem_tpu/parallel/sharded.py``.  The JAX factories wrap
the block functions of ``frame/pipeline.py`` in ``jax.shard_map`` and take
global arrays; these take and return the calling rank's **local block**
(``parallel/mesh.py::local_block`` cuts it, ``gather_blocks`` assembles the
result), and every rank of the mesh makes the same call:

* encode is line-local: no communication at all;
* decode extends the rank's line block with its stencil halo (one batch of
  point-to-point sends and receives on the line ring,
  ``parallel/halo.py``), runs the *unchanged* block decoder on the
  extended block, and crops, so the sharded output agrees with the
  unsharded pipeline line for line.

Each rank recomputes the halo lines' demodulation itself (a few lines of
redundant work) instead of exchanging state after the demodulation: one
exchange per decode.  The absolute line index of every line, halo lines
included, is arithmetic of the rank's mesh position; at the global edges
it follows the composite's edge rule, so edge halo lines demodulate
exactly like the in-frame lines the unsharded reflection reads.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.dsp.nco import TWO_PI, f32, frame_indices
from color_modem_tpu_torch.frame.interlace import field_offset, split_fields, weave_fields
from color_modem_tpu_torch.frame.pipeline import (
    Plan,
    _check_backend,
    check_decoder,
    decode_block,
    encode_block,
)
from color_modem_tpu_torch.modem.plan import plan_on
from color_modem_tpu_torch.parallel.halo import (
    crop_halo,
    halo_extend,
    halo_extend_frames,
    ring_exchange,
)
from color_modem_tpu_torch.parallel.mesh import (
    FLAT,
    FRAME_AXIS,
    LINE_AXIS,
    Mesh,
    from_comm,
    line_block,
    ring_all_gather,
    to_comm,
)
from color_modem_tpu_torch.standards.decoders import comb_spacing, temporal_comb_spacing

TEMPORAL = ("comb3d", "comb3dA")


def required_halo(plan: Plan, decoder: str) -> int:
    """LINE-stencil depth of the decode path: comb spacing for every
    line-comb variant (fixed and adaptive), else the 1-line
    pairing/averaging shift (SECAM pairing, NIIR normalize, delay line).

    FM/NIIR 'avg' CHAINS two 1-line stencils (pairing (SECAM) or
    reference normalisation (NIIR), then neighbour averaging), so its
    composed reach is 2 lines."""
    if decoder in ("comb2", "comb3", "combA", "comb3dA"):
        return comb_spacing(plan.cfg)
    if decoder == "avg" and (
        plan.cfg.is_fm
        or getattr(plan.cfg.chroma, "reference_amplitude", None) is not None
    ):
        return 2
    return 1


def halo_edge_rule(plan: Plan, decoder: str) -> str:
    """Global-edge substitution rule paired with :func:`required_halo`: the
    chained 1-line prev-stencils of FM/NIIR 'avg' need 'copy' (see
    ``halo_extend``'s docstring for the index algebra), every single
    stencil uses 'reflect'.  Both reproduce the unsharded pipeline's
    boundary treatment."""
    if decoder == "avg" and required_halo(plan, decoder) == 2:
        return "copy"
    return "reflect"


# --- absolute line indices: arithmetic of the mesh position ------------------


def _block_frames(mesh: Mesh, frame0, b_blk: int) -> torch.Tensor:
    """(b_blk,) int32 absolute frame numbers of this rank's frame block."""
    return frame_indices(frame0, b_blk, mesh.device) + mesh.index(FRAME_AXIS) * b_blk


def _ext_frame_offsets(mesh: Mesh, b_blk: int, pt: int) -> torch.Tensor:
    """Frame offsets (from the frame axis' start) of a frame-halo-extended
    block: the one place the temporal edge rule lives for the line index.
    Interior halos are the contiguous neighbour frames; the global first
    and last blocks substitute the in-block frames an odd multiple of
    ``pt`` away, mirroring ``halo_extend_frames`` and
    ``stencil.prev_reflect_frames``."""
    idx, nf = mesh.index(FRAME_AXIS), mesh.size(FRAME_AXIS)
    foff = idx * b_blk
    e = torch.arange(b_blk + 2 * pt, dtype=torch.int32, device=mesh.device)
    f = foff + e - pt
    if idx == 0:
        f = torch.where(e < pt, foff + e + pt, f)
    if idx == nf - 1:
        f = torch.where(e >= b_blk + pt, foff + e - 3 * pt, f)
    return f


def _block_rows(mesh: Mesh, l_blk: int, h: int = 0, edge: str = "reflect") -> torch.Tensor:
    """(l_blk + 2h,) int32 line (or field row) numbers of this rank's line
    block extended by ``h`` halo lines: the contiguous neighbours inside the
    frame, the ``edge`` rule's lines past its top and bottom (what
    ``halo_extend`` puts there)."""
    idx, nl = mesh.index(LINE_AXIS), mesh.size(LINE_AXIS)
    loff = idx * l_blk
    e = torch.arange(l_blk + 2 * h, dtype=torch.int32, device=mesh.device)
    r = loff + e - h
    if h and idx == 0:
        r = torch.where(e < h, e if edge == "copy" else h - e, r)
    if h and idx == nl - 1:
        k = e - (l_blk + h)
        past = loff + l_blk - h + k if edge == "copy" else loff + l_blk - 2 - k
        r = torch.where(k >= 0, past, r)
    return r


def _gline(plan: Plan, frames: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(F, R) absolute line indices of progressive frames x rows."""
    return frames[:, None] * plan.total_lines + rows[None, :]


def _field_gline(plan: Plan, frames: torch.Tensor, rows: torch.Tensor,
                 parity_major: bool = False) -> torch.Tensor:
    """Absolute line indices of both fields of ``frames`` at field ``rows``
    (``frame/interlace.py::field_line_index`` at the rank's offsets):
    (2F, R) field-sequential, or (2, F, R) parity-major."""
    p = torch.arange(2, dtype=torch.int32, device=rows.device) * field_offset(plan)
    if parity_major:
        return (frames[None, :, None] * plan.total_lines + p[:, None, None]
                + rows[None, None, :])
    g = frames[:, None, None] * plan.total_lines + p[None, :, None] + rows[None, None, :]
    return g.reshape(2 * frames.shape[0], rows.shape[0])


def _input(mesh: Mesh, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=mesh.device)


# --- the composite pipelines -------------------------------------------------


def make_sharded_pipeline(plan: Plan, mesh: Mesh, decoder: str = "notch",
                          backend: str = "kernel"):
    """``(encode, decode, roundtrip)`` over the rank's blocks.

    encode: (B/F, 3, L/Lb, N) -> (B/F, L/Lb, N); decode the reverse;
    ``frame0`` is the global batch's first frame.  B must divide the frame
    axis, L the line axis (``parallel/mesh.py::pad_to_multiple`` when it
    does not).  ``backend`` selects the rank's compute path ('kernel' or
    'plain'); the halo logic is the same either way.  The temporal combs
    exchange frame halos on the frame ring (and comb3dA line halos too);
    they need at least ``2 * temporal_comb_spacing`` frames per block.
    """
    check_decoder(plan, decoder)
    _check_backend(backend)
    h = required_halo(plan, decoder)
    edge = halo_edge_rule(plan, decoder)
    plan = plan_on(plan, mesh.device)

    @torch.inference_mode()
    def encode(rgb_blk, frame0=0):
        rgb_blk = _input(mesh, rgb_blk)
        b, _, l, _ = rgb_blk.shape
        g = _gline(plan, _block_frames(mesh, frame0, b), _block_rows(mesh, l))
        return encode_block(plan, rgb_blk, g, backend)

    @torch.inference_mode()
    def decode(comp_blk, frame0=0):
        comp_blk = _input(mesh, comp_blk)
        b, l, _ = comp_blk.shape
        if decoder in TEMPORAL:
            # the temporal comb's stencil crosses the frame axis: frame halos
            # on the frame ring, the halo frames' line index from the mesh
            # position; comb3dA's spatial half adds the line halos
            pt = temporal_comb_spacing(plan.cfg)
            cext = halo_extend_frames(comp_blk, pt, mesh)
            frames = frame_indices(frame0, 1, mesh.device) + _ext_frame_offsets(mesh, b, pt)
            hl = h if decoder == "comb3dA" else 0
            if hl:
                cext = halo_extend(cext, hl, mesh)
            gext = _gline(plan, frames, _block_rows(mesh, l, hl))
            rgb = decode_block(plan, cext, gext, decoder, backend)[pt : pt + b]
            return crop_halo(rgb, hl) if hl else rgb
        cext = halo_extend(comp_blk, h, mesh, edge=edge)
        gext = _gline(plan, _block_frames(mesh, frame0, b), _block_rows(mesh, l, h, edge))
        return crop_halo(decode_block(plan, cext, gext, decoder, backend), h)

    def roundtrip(rgb_blk, frame0=0):
        return decode(encode(rgb_blk, frame0), frame0)

    return encode, decode, roundtrip


def make_sharded_interlaced_pipeline(plan: Plan, mesh: Mesh, decoder: str = "notch",
                                     backend: str = "kernel"):
    """Sharded 2:1 interlaced pipeline (``frame/interlace.py`` over the
    mesh): ``encode (B/F, 3, L/Lb, N) -> (2B/F, L/(2Lb), N)``
    field-sequential composite, ``decode`` weaves back.

    Both the field split and the weave are rank-local: a rank owning
    spatial lines ``[jL_b, (j+1)L_b)`` owns field rows ``[jL_b/2,
    (j+1)L_b/2)`` of BOTH parities, contiguous runs of the global field-row
    axis, so the composite blocks are the global field-sequential array's
    ``(frame, lineblk)`` blocks.  Line combs comb transmitted-adjacent
    lines, which are field-row neighbours, so the row-axis ring halos apply
    unchanged; comb3d/comb3dA regroup parity-major on each rank (it holds
    both fields of its frames) and exchange frame halos per parity group.

    Needs B divisible by the frame axis (at least ``2*spacing`` frames per
    rank for the temporal combs), L even and L/2 divisible by the line
    axis with at least halo+1 rows per block.
    """
    check_decoder(plan, decoder)
    _check_backend(backend)
    h = required_halo(plan, decoder)
    edge = halo_edge_rule(plan, decoder)
    plan = plan_on(plan, mesh.device)

    @torch.inference_mode()
    def encode(rgb_blk, frame0=0):
        rgb_blk = _input(mesh, rgb_blk)
        b = rgb_blk.shape[0]
        fields = split_fields(rgb_blk)
        g = _field_gline(plan, _block_frames(mesh, frame0, b),
                         _block_rows(mesh, fields.shape[-2]))
        return encode_block(plan, fields, g, backend)

    @torch.inference_mode()
    def decode(comp_blk, frame0=0):
        comp_blk = _input(mesh, comp_blk)
        b2, rows, n = comp_blk.shape
        b = b2 // 2
        if decoder in TEMPORAL:
            pt = temporal_comb_spacing(plan.cfg)
            cp = comp_blk.reshape(b, 2, rows, n).transpose(0, 1)
            cext = halo_extend_frames(cp, pt, mesh)
            frames = frame_indices(frame0, 1, mesh.device) + _ext_frame_offsets(mesh, b, pt)
            hl = h if decoder == "comb3dA" else 0
            if hl:
                cext = halo_extend(cext, hl, mesh)
            gext = _field_gline(plan, frames, _block_rows(mesh, rows, hl), parity_major=True)
            out = decode_block(plan, cext, gext, decoder, backend)[:, pt : pt + b]
            if hl:
                out = crop_halo(out, hl)
            return weave_fields(out.transpose(0, 1).reshape(b2, 3, rows, n))
        cext = halo_extend(comp_blk, h, mesh, edge=edge)
        gext = _field_gline(plan, _block_frames(mesh, frame0, b),
                            _block_rows(mesh, rows, h, edge))
        return weave_fields(crop_halo(decode_block(plan, cext, gext, decoder, backend), h))

    def roundtrip(rgb_blk, frame0=0):
        return decode(encode(rgb_blk, frame0), frame0)

    return encode, decode, roundtrip


def make_sharded_mac_pipeline(plan, mesh: Mesh):
    """``(encode, decode, roundtrip)`` for the MAC family over the rank's
    blocks.  MAC needs no QAM or FM machinery: encode is line-local, and
    decode's only cross-line dependency is the +-1-line neighbour average of
    the line-sequential colour: halo 1, reflect edges.  ``plan`` is a
    ``modem/mac_plan.py::MacPlan``; blocks are (B/F, 3, L/Lb, W) <->
    (B/F, L/Lb, 1296)."""
    from color_modem_tpu_torch.modem import mac

    @torch.inference_mode()
    def encode(rgb_blk, frame0=0):
        rgb_blk = _input(mesh, rgb_blk)
        b, _, l, _ = rgb_blk.shape
        return mac.encode(plan, rgb_blk, _gline(plan.cfg, _block_frames(mesh, frame0, b),
                                                _block_rows(mesh, l)))

    @torch.inference_mode()
    def decode(sig_blk, frame0=0):
        sig_blk = _input(mesh, sig_blk)
        b, l, _ = sig_blk.shape
        sext = halo_extend(sig_blk, 1, mesh)
        gext = _gline(plan.cfg, _block_frames(mesh, frame0, b), _block_rows(mesh, l, 1))
        return crop_halo(mac.decode(plan, sext, gext), 1)

    def roundtrip(rgb_blk, frame0=0):
        return decode(encode(rgb_blk, frame0), frame0)

    return encode, decode, roundtrip


def make_sharded_palplus_pipeline(plan: Plan, mesh: Mesh, decoder: str = "comb3",
                                  backend: str = "kernel", helper_gain: float = 1.0):
    """``(encode, decode, roundtrip)`` for PALplus over the rank's blocks:
    **data-parallel over frames only**.

    The PALplus vertical filter bank (``frame/palplus.py``) is a global
    linear map along the line axis: the letterbox resample and the helper's
    modulated decimation each touch every line of the frame, so a line
    split would turn the (L, 3L/4) resample products into gathers of the
    whole luma plane per stage.  A whole frame is far below one device's
    memory, so frames shard and lines do not: the mesh's line axis must be
    1.  Blocks are (B/F, 3, L, N) <-> (B/F, L, N).
    """
    from color_modem_tpu_torch.frame.palplus import (
        PalPlusGeometry,
        decode_palplus,
        encode_palplus,
    )

    PalPlusGeometry(plan.cfg.active_lines)  # validate the standard's raster
    if mesh.size(LINE_AXIS) != 1:
        raise ValueError(
            "PALplus shards frames only (vertical filter bank is global "
            f"along lines) — build the mesh with {LINE_AXIS}=1, got {mesh.shape}"
        )
    check_decoder(plan, decoder)
    _check_backend(backend)
    plan = plan_on(plan, mesh.device)

    def _g(frame0, b: int, l: int) -> torch.Tensor:
        rows = torch.arange(l, dtype=torch.int32, device=mesh.device)
        return _gline(plan, _block_frames(mesh, frame0, b), rows)

    @torch.inference_mode()
    def encode(rgb_blk, frame0=0):
        rgb_blk = _input(mesh, rgb_blk)
        g = _g(frame0, rgb_blk.shape[0], rgb_blk.shape[-2])
        return encode_palplus(plan, rgb_blk, g, backend, helper_gain)

    @torch.inference_mode()
    def decode(comp_blk, frame0=0):
        comp_blk = _input(mesh, comp_blk)
        g = _g(frame0, comp_blk.shape[0], comp_blk.shape[-2])
        return decode_palplus(plan, comp_blk, g, decoder, backend, helper_gain)

    def roundtrip(rgb_blk, frame0=0):
        return decode(encode(rgb_blk, frame0), frame0)

    return encode, decode, roundtrip


# --- the transmission hops ----------------------------------------------------


def hop_stage(mesh: Mesh, comp_blk: torch.Tensor, frame0, hop, *streams, units: int = 1):
    """Run a frame-local hop on whole frames.

    The line ring gathers its line blocks into whole frames (the hop runs
    on each frame's rows joined into one broadcast-time stream, so it
    cannot split lines).  When the rank's frames divide the line ring, the
    ring spreads them over its members (the batch over the whole flat grid,
    every rank busy, a rank's frames following the flat ring's order) and
    gathers the results back; otherwise every member runs the hop on all of
    them (the frame-axis fallback).  ``units``: composite items per frame
    (2 for field-sequential fields).  ``streams``: per-frame side inputs
    (audio) that ride with their frames; ``hop(comp, *streams, frame0)``
    returns the composite, or a tuple of the composite and per-frame or
    per-item outputs (None where there is none).  Returns whole frames of
    the rank's frame block: the composite, or the tuple.
    """
    full = ring_all_gather(mesh, LINE_AXIS, comp_blk, dim=-2)
    b, nl = full.shape[0] // units, mesh.size(LINE_AXIS)
    f0 = frame0 + mesh.index(FRAME_AXIS) * b
    if b % nl:
        return hop(full, *streams, f0)
    s, j = b // nl, mesh.index(LINE_AXIS)
    out = hop(full[j * s * units : (j + 1) * s * units],
              *(x[j * s : (j + 1) * s] for x in streams), f0 + j * s)
    if isinstance(out, torch.Tensor):
        return ring_all_gather(mesh, LINE_AXIS, out.contiguous(), dim=0)
    return tuple(None if o is None else ring_all_gather(mesh, LINE_AXIS, o.contiguous(), dim=0)
                 for o in out)


def make_sharded_hop_pipeline(plan: Plan, mesh: Mesh, hop, decoder: str = "notch",
                              backend: str = "kernel"):
    """encode -> frame-local transmission hop -> decode over the rank's
    blocks.

    The RF and satellite hops (``frame/rf.py``, ``frame/satellite.py``)
    consume each frame's rows JOINED into one broadcast-time stream, so the
    hop stage gathers the line ring's blocks into whole frames and spreads
    the batch over the whole flat grid (frames are independent): every rank
    processes whole frames, none idles, and the results are gathered and
    re-split into line blocks after it.  When the batch does not divide the
    rank count, the hop falls back to frame-axis sharding (the members of a
    line ring then repeat the hop).  The composite encode and decode keep
    their full (frame, lineblk) split and ring halos throughout.

    ``hop(comp, frame0) -> comp`` must be frame-local (batch items
    independent) and keyed on the ABSOLUTE frame index, e.g. ``lambda c, f0:
    rf_roundtrip(rfp, c, f0)``.  The sharded output matches the unsharded
    enc -> hop -> dec chain to float tolerance, not bit for bit: the hop's
    stream FFTs run on a batch of another size.
    """
    enc, dec, _ = make_sharded_pipeline(plan, mesh, decoder, backend)

    @torch.inference_mode()
    def roundtrip(rgb_blk, frame0=0):
        comp = hop_stage(mesh, enc(rgb_blk, frame0), frame0, hop)
        return dec(line_block(mesh, comp), frame0)

    return enc, dec, roundtrip


def make_sharded_hop_audio_pipeline(plan: Plan, mesh: Mesh, hop, decoder: str = "notch",
                                    backend: str = "kernel"):
    """:func:`make_sharded_hop_pipeline` for FRAME-LOCAL hops that carry an
    audio stream beside the video: the satellite link with its FM
    subcarrier ladder (``frame/satellite.py``: per-frame circular FM, so
    each frame's audio block is ONE PERIOD and shards with its frame; no
    state crosses ranks by construction).

    ``hop(comp, aud, frame0) -> (comp, aud_rx)`` must be frame-local in
    BOTH streams; audio is the rank's frame block ``(B/F, K, S)`` (or
    ``(B/F, S)``, taken as K=1), one block of ``S`` baseband samples per
    frame per subcarrier, the same on every rank of a line ring.  Returns
    ``roundtrip(rgb_blk, aud_blk, frame0) -> (rgb_blk, aud_rx)``, the
    received audio of the rank's frame block; the batch spreading and the
    frame-axis fallback are the video-only factory's.
    """
    enc, dec, _ = make_sharded_pipeline(plan, mesh, decoder, backend)

    @torch.inference_mode()
    def roundtrip(rgb_blk, aud_blk, frame0=0):
        aud = _input(mesh, aud_blk)
        if aud.ndim == 2:
            aud = aud[:, None, :]
        comp, aud_rx = hop_stage(mesh, enc(rgb_blk, frame0), frame0, hop, aud)
        return dec(line_block(mesh, comp), frame0), aud_rx

    return enc, dec, roundtrip


def sound_from_rf_ring(mesh: Mesh, rfp, rf: torch.Tensor, frame0) -> torch.Tensor:
    """The sound takeoff of this rank's RF items (B, L, N*r), consecutive
    items of one broadcast stream laid along the flat ring: ONE neighbour
    item of RF each way around the ring, demodulated with the own items
    (``frame/rf.py::sound_from_rf_halo``) and cropped.  The global first
    and last ranks get zero halo items with the discriminator dead over
    them, which reproduces the unsharded stream's ends.  ``frame0``: the
    absolute index of the first own item.  Returns (B, L*N) audio."""
    from color_modem_tpu_torch.frame.rf import sound_from_rf_halo

    n, me = mesh.n_ranks, mesh.index(FLAT)
    from_prev, from_next = ring_exchange(mesh, FLAT, rf[:1], rf[-1:])
    zero = torch.zeros_like(rf[:1])
    rf_ext = torch.cat([zero if from_prev is None else from_prev, rf,
                        zero if from_next is None else from_next])
    return sound_from_rf_halo(rfp, rf_ext, frame0 - 1, 1, head_dead=me == 0,
                              tail_dead=me == n - 1)


def make_sharded_rf_sound_pipeline(plan: Plan, mesh: Mesh, rfp, decoder: str = "notch",
                                   backend: str = "kernel"):
    """encode -> RF hop CARRYING THE JOINED-STREAM FM SOUND -> decode over
    the rank's blocks: the one subsystem whose state crosses the batch.

    The intercarrier sound carrier runs over the frames JOINED as one
    broadcast-time stream (``frame/rf.py::sound_on_rf``): its deviation
    integral is a running sum ACROSS frames, the batch-crossing dependency
    frame sharding would silently break.  The runner's prefix-phase rule
    makes it shard-clean, here with collectives:

    * **transmit** — each rank integrates its own sub-batch's deviation
      and seeds it with ``phi0``, the exclusive prefix of the per-rank
      deviation sums around the flat rank ring: one ``all_gather`` of a
      float64 scalar per rank, summed in float64 and reduced mod 2 pi,
      as the port's unsharded modulator integrates (in float64, ``dsp/
      nco.py::running_phase``).  A rank's phase differs from the unsharded
      joined sum only by float64 reassociation.
    * **receive** — the sound takeoff's stream filters need true neighbour
      context at rank boundaries: :func:`sound_from_rf_ring`, one
      neighbour frame of RF each way around the same flat ring, zeros with
      a dead discriminator at the global ends.

    Video stays frame-local and is spread like
    :func:`make_sharded_hop_pipeline`'s flat path; the composite encode and
    decode keep their full (frame, lineblk) split and ring halos.  The
    batch must divide the rank count (every rank holds the same number of
    consecutive frames of the stream).

    Returns ``(encode, decode, roundtrip)`` with ``roundtrip(rgb_blk,
    aud_blk, frame0) -> (rgb_blk, aud_rx)``; ``aud_blk`` is the rank's
    frame block (B/F, L*N) in [-1, 1] at the composite rate (consecutive
    frames of one stream, the same on every rank of a line ring), and
    ``aud_rx`` the received audio of that block.
    """
    import torch.distributed as dist

    from color_modem_tpu_torch.frame.rf import rf_demodulate, rf_modulate, sound_on_rf

    enc, dec, _ = make_sharded_pipeline(plan, mesh, decoder, backend)
    n, me = mesh.n_ranks, mesh.index(FLAT)
    step = f32(TWO_PI * rfp.snd_dev / rfp.fs_rf)

    def _hop(comp, aud, f0):
        rf = rf_modulate(rfp, comp, f0)
        # transmit: the deviation phase before this rank's frames, the
        # float64 exclusive prefix around the flat ring (each composite
        # sample is held r times at the RF rate)
        local = (rfp.r * (step * aud).to(torch.float64).sum()).reshape(1)
        send = to_comm(mesh, local)
        totals = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(totals, send)
        phi0 = torch.remainder(from_comm(mesh, torch.cat(totals)[:me].sum()), TWO_PI)
        rf = sound_on_rf(rfp, rf, f0, aud, phi0)
        return rf_demodulate(rfp, rf, f0), sound_from_rf_ring(mesh, rfp, rf, f0)

    @torch.inference_mode()
    def roundtrip(rgb_blk, aud_blk, frame0=0):
        b = rgb_blk.shape[0]
        if b % mesh.size(LINE_AXIS):
            raise ValueError(
                f"batch {b * mesh.size(FRAME_AXIS)} must divide the {n}-rank grid — the "
                "joined-stream sound ring gives every rank an equal consecutive sub-batch"
            )
        aud = _input(mesh, aud_blk)
        comp, aud_rx = hop_stage(mesh, enc(rgb_blk, frame0), frame0, _hop, aud)
        return dec(line_block(mesh, comp), frame0), aud_rx

    return enc, dec, roundtrip
