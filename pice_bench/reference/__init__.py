"""Plain float32 references of the served architectures, one file a
`family`: `dense` (qwen3 / qwen2 decoders) and `hybrid` (Mamba2 + a
shared attention block, zamba2). Each exposes `run(spec, seed, seqs,
device, control)`."""
