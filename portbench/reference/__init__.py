"""Plain references, one module a kind of configuration. They import torch
and numpy only: no code of the port and no code of the JAX package."""
