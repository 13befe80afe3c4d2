"""Host wall ms a batch of the program's `occ_subnet` span, in the traced eval window."""


def read(layers):
    return layers.stage_host_ms("occ_subnet")
