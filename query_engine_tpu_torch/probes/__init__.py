"""Probes: the port's counterparts of the JAX package's kernel probes in
`benchmarks/`, named after them. Each module is an entry point
(`python -m query_engine_tpu_torch.probes.<name>`) and a library of the
functions it probes."""
