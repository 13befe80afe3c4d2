"""Host wall ms a batch of the program's `roi_grid_pool` span (the RoI-grid points' ball queries and MLPs), in the traced eval window."""


def read(layers):
    return layers.stage_host_ms("roi_grid_pool")
