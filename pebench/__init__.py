"""The benchmark of physicedit_torch (see run.py)."""
