"""The benchmark's plain reference (`btcref`, a frozen float32 copy of the
detector with the kernels' plain versions), its stage-by-stage
comparison (`stages`) and its lower-precision control (`lowp`)."""
