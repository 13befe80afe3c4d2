"""Host wall ms a batch of the program's `backbone_3d` span, in the traced eval window."""


def read(layers):
    return layers.stage_host_ms("backbone_3d")
