"""Active sites the strided sparse convs kept under their level capacities
over the distinct sites they wanted, in percent (tallies
`backbone.sites_kept` and `backbone.sites_wanted`, recorder window)."""

from benchmark.lib import recorder


def read(layers):
    r = recorder.result(layers)
    return None if r is None else r["backbone_sites_kept_pct"]
