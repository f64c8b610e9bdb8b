"""Multi-GPU rendering and training on torch.distributed (the JAX package's
`parallel/`): a one-axis mesh of ranks (`mesh.py`) and the multi-process
set-up (`multihost.py`)."""
