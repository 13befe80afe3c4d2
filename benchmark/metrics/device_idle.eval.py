"""Share of the traced window in which no device operation ran, in percent."""


def read(layers):
    return layers.idle_pct()
