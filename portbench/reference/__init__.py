"""The plain reference: numpy and plain PyTorch in float32 (or the control's
lower precision), importing nothing of the program and nothing of JAX."""
