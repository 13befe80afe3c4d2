"""Model FLOPs of the window's batches over the window and the bf16 peak, in percent."""


def read(layers):
    return layers.mfu()
