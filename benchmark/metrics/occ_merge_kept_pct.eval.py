"""New cells kept as rows of the merged det table over the new cells the
occupancy points offered, in percent (tallies `occ.merge.new_rows` and
`occ.merge.new_cells`, recorder window)."""

from benchmark.lib import recorder


def read(layers):
    r = recorder.result(layers)
    return None if r is None else r["occ_merge_kept_pct"]
