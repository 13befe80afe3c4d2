"""Host wall ms a batch of the program's `bev` and `dense_head` spans (BEV pyramid and RPN head)."""


def read(layers):
    return layers.stage_host_ms("bev", "dense_head")
