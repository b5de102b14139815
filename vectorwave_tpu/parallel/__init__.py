from .mesh import default_mesh, make_mesh
from .batch import shard_batch, modwt_multilevel_sharded_batch
from .tiled import (
    imodwt_multilevel_tiled,
    modwt_multilevel_tiled,
    tiled_roundtrip_check,
)
from .cwt_tiled import cwt_tiled, cwt_tiled_2d
from .tiled2d import imodwt2_multilevel_tiled, modwt2_multilevel_tiled
from .multihost import (
    CommunicationReport,
    communication_report,
    imodwt_multilevel_multihost,
    make_multihost_mesh,
    modwt_multilevel_multihost,
)

__all__ = [
    "cwt_tiled",
    "cwt_tiled_2d",
    "make_mesh",
    "default_mesh",
    "shard_batch",
    "modwt_multilevel_sharded_batch",
    "modwt_multilevel_tiled",
    "imodwt_multilevel_tiled",
    "modwt2_multilevel_tiled",
    "imodwt2_multilevel_tiled",
    "tiled_roundtrip_check",
    "make_multihost_mesh",
    "modwt_multilevel_multihost",
    "imodwt_multilevel_multihost",
    "communication_report",
    "CommunicationReport",
]
