"""The plain reference of the benchmark: SQAIR's train step in plain
PyTorch (a frozen copy of the program's model code, with plain tensor
operations in place of its kernels), which the benchmark holds the
program's timed path to.  It imports nothing of the program and nothing of
JAX."""
