"""Model architectures the benchmark can build: the seeded weights and the
program's model made from them, one module an architecture."""
