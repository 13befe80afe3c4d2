"""Multi-GPU data parallelism and BEV row sharding (counterpart of
`btcdet_tpu/parallel/`)."""

from .dist import (  # noqa: F401
    all_reduce_grads,
    all_reduce_sum,
    barrier,
    broadcast_object,
    broadcast_state,
    data_parallel_group,
    destroy,
    gather_objects,
    get_dist_info,
    get_sp_info,
    global_rows,
    init_dist,
    is_lead,
    merge_results_dist,
    spatial_group,
)
from .spatial import gather_rows, halo_rows, take_rows  # noqa: F401
