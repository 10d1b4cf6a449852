"""Multi-device parallelism (counterpart of fennec_tpu/parallel): the
data-parallel mesh and the batched and mesh-sharded device programs.

The reference's CompressBatch worker pool (batch.go:58-128) becomes a
batch axis split over a DataMesh: each device (or each shard of one
device) searches its rows of a chunk in a thread of its own; no
cross-device traffic on the search itself.  The JAX package's spatial
axis (rows of one image over chips) is not ported.
"""

from .mesh import DataMesh, data_mesh, make_mesh  # noqa: F401
from .batched import (  # noqa: F401
    batched_quality_search,
    batched_quality_search_sharded,
    batched_ssim,
)
