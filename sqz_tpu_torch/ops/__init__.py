"""Device paths of the port: the sqz4 kernels, their plain PyTorch
versions, the host glue around them, and the block-level engine.

Importing this package builds and loads nothing; the CUDA library is
built on the first kernel launch (``_build``)."""
