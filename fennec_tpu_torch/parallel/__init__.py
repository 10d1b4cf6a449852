"""Multi-device parallelism (counterpart of fennec_tpu/parallel): the
data-parallel mesh and the batched and mesh-sharded device programs.

The reference's CompressBatch worker pool (batch.go:58-128) becomes a
batch axis split over a DataMesh: each device searches its rows of a
chunk in a thread of its own (the shards of one device in turn, each on
its own stream); no cross-device traffic on the search itself.  The spatial axis of a
DataSpatialMesh splits one image's rows over devices in bands, each band
reading a halo from the next and sending its part of the result to the
mesh's first device (quality_search_spatial_sharded).
"""

from .mesh import (  # noqa: F401
    DataMesh,
    DataSpatialMesh,
    data_mesh,
    data_spatial_mesh,
    make_mesh,
)
from .batched import (  # noqa: F401
    batched_quality_search,
    batched_quality_search_sharded,
    batched_ssim,
    quality_search_spatial_sharded,
)
