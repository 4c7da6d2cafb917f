"""The plain PyTorch reference that decides a run's ``correct``. It imports
nothing of the program and neither JAX nor the JAX package."""
