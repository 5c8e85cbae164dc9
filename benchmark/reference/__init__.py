"""Plain references, one module per configuration's "reference" key.

Plain torch, in the precision a caller asks for, on whichever device the
tensors are on. A reference imports neither jax nor either package of the
program (harness.py scans these files before each check), and takes
nothing that the program made: it reads the benchmark's inputs, the
initial tables that benchmark.init draws, and the program's outputs,
which it judges.
"""
