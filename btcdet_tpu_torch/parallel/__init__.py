"""Multi-GPU data parallelism (counterpart of `btcdet_tpu/parallel/`)."""

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
    global_rows,
    init_dist,
    merge_results_dist,
)
