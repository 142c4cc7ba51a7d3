"""Benchmarks of the port: the paper's accuracy arms (Table II)."""
