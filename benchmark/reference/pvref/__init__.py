"""A frozen copy of the PV-RCNN eval path in plain PyTorch, float32
everywhere, with the plain furthest point sampling and ball queries: the
benchmark's reference for a `MODEL.NAME` PVRCNN configuration. MeanVFE,
the sparse backbone, HeightCompression, the BEV pyramid, the anchor head,
the proposal layer and the NMS are `btcref`'s (imported, not copied). It
imports nothing of the port it is held against."""
