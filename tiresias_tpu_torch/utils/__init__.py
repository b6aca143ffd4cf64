"""Host utilities: audio I/O, hashing, logging, tracing, the kernel build."""
