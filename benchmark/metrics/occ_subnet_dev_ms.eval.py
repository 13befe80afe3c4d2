"""Device ms a batch of the operations launched inside the program's `occ_subnet` span."""


def read(layers):
    return layers.stage_dev_ms("occ_subnet")
