"""picasso_torch.parallel: the work of one call spread over several
devices of one process.

Counterpart of picasso_tpu/parallel (a 1D ``("spots",)`` device mesh
under jax.sharding). Here a :class:`~picasso_torch.parallel.mesh.Mesh` is
a tuple of torch devices, one shard each, run by one host thread a shard
on its device's current stream; spot, frame, pair, candidate and cluster
batches split over the shards with no communication, and the render
histograms are summed on the first device in shard order.
"""

from picasso_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    default_mesh,
    fit_mle_sharded,
    render_hist_sharded,
    sharded_pipeline_step,
)
