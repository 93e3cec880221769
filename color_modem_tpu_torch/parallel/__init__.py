"""Parallelism layer on ``torch.distributed``: the rank mesh, halo exchange
over its rings, and the sharded pipelines, one rank per (frame, lineblk)
block.  Port of ``color_modem_tpu/parallel/``; ``multihost.py`` launches
the ranks."""

from color_modem_tpu_torch.parallel.halo import (  # noqa: F401
    crop_halo,
    halo_extend,
    halo_extend_lines,
)
from color_modem_tpu_torch.parallel.mesh import (  # noqa: F401
    FRAME_AXIS,
    LINE_AXIS,
    gather_blocks,
    init_distributed,
    local_block,
    make_mesh,
    pad_to_multiple,
)
from color_modem_tpu_torch.parallel.sharded import (  # noqa: F401
    make_sharded_hop_audio_pipeline,
    make_sharded_hop_pipeline,
    make_sharded_interlaced_pipeline,
    make_sharded_palplus_pipeline,
    make_sharded_pipeline,
    make_sharded_rf_sound_pipeline,
    required_halo,
)
