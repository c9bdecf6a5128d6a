r"""The benchmark of the PyTorch and CUDA port (``a3gc_tpu_torch``) on one
H100: see ``portbench/README.md``."""
