"""The data factory of the port (counterpart of ``a3gc_tpu/data/factory``):
raw AMASS, DIP-IMU and TotalCapture → packed training sets and test sets,
and the test-set reader."""
from a3gc_tpu_torch.data.factory import (  # noqa: F401
    amass, dipimu, totalcapture, transform)
