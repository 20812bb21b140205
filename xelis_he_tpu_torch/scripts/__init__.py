"""Measurement scripts of the port, run as ``python -m
xelis_he_tpu_torch.scripts.<name>``: the roofline probes (bench_roofline,
bench_fe13, bench_qtile), ports of the JAX package's scripts/ of those names."""
