"""The benchmark's harness: cells, catalog, traffic, trace reading and the
correctness check. Imports the program (``tiresias_tpu_torch``) only where
it drives the system under test, and never JAX."""
