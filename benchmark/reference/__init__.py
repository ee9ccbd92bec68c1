"""The benchmark's yardstick: plain references of the solved models, the
frozen operation and byte counts, the table of peaks, and the comparison
that decides ``correct``.  Nothing here imports the port or JAX."""
