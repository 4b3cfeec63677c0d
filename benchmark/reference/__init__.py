"""The plain reference the benchmark holds the port to: plain PyTorch and NumPy,
float32 unless a control asks for less. It imports nothing of the port."""
