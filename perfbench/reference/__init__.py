"""The plain references: one application of each program in plain PyTorch.

They import neither JAX nor anything of gt4py_tpu or gt4py_tpu_torch, and
take nothing the program made: the harness hands them the same inputs it
hands the program, or the program's state where they follow it (check.py).
Each computes in the dtype of the tensors it is given: float64 for the
reference, a lower precision for the control (control.py).
"""
