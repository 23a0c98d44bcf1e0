"""The benchmark's plain reference: float32 PyTorch, no kernel and nothing of
the program under test (``unidefense_torch``) or of the JAX package."""
