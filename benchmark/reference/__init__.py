"""The benchmark's plain reference: baseline JPEG read and written in NumPy
and float64 PyTorch, independent of the program under test (it imports
nothing of it, nor JAX)."""
