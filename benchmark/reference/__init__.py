"""The plain reference the benchmark holds the program against: the towers,
the losses and AdamW in float32 PyTorch (TF32 off), written from the
published descriptions.  It imports nothing of the program, and nothing of
JAX."""
