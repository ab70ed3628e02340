"""The plain reference: plain PyTorch (fp32, TF32 off) and NumPy, one file
a model part.  It imports nothing of the program and takes nothing the
program made."""
