"""The benchmark of the PyTorch and CUDA port (``sqz_tpu_torch``): cells
of ``BENCHMARK.json`` at the root of the repository, run by
``python3 -m portbench.run``. Nothing here imports JAX or the JAX
package; ``reference/`` imports nothing of the port either."""
