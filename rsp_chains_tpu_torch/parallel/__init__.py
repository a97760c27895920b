from .mesh import CHANNEL_AXIS, RANGE_AXIS, Mesh, auto_mesh, chain_spec, make_mesh
from .halo import exchange_halo, extend_with_halo
from .sharded import (
    cfar_2d_halo_shard,
    cfar_halo_shard,
    channel_sharded,
    gather,
    make_sharded_pipeline,
    make_sharded_rd_pipeline,
    range_sharded_fir,
    range_sharded_mag_cfar,
    scatter,
)
