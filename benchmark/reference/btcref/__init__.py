"""A frozen copy of the BtcNet detector in plain PyTorch, float32
everywhere, with the plain versions of every kernel: the benchmark's
reference. It imports nothing of the port it is held against."""
