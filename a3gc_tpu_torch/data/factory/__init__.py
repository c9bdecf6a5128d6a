"""Dataset readers of the port (counterpart of ``a3gc_tpu/data/factory``:
for now the test-set reader of ``dipimu``)."""
