"""The plain reference: float32 PyTorch with TF32 off, written from the
published architectures and the port's documented parameter layout.  It
imports nothing of the program and takes nothing the program made."""
