"""Device ms a batch of the operations launched inside the program's `roi_grid_pool` span."""


def read(layers):
    return layers.stage_dev_ms("roi_grid_pool")
