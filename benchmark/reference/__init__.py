"""The benchmark's plain reference: what the program should answer,
computed again from the benchmark's own inputs in plain PyTorch. Imports
nothing of the program and nothing of JAX."""
