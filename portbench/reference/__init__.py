"""The plain reference the program's outputs are judged against: plain
PyTorch and numpy in float32 with TF32 off, importing neither JAX nor
anything of the program."""
