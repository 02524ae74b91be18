"""The plain reference of what the benchmark's cells compute, in float32
(float64 for search scores) with TF32 off, written for the benchmark from
the published definitions. It imports nothing of the program, of the
repository's tests or of JAX."""
