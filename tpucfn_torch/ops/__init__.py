"""Plain PyTorch numerics (the references the kernels are held to)."""
