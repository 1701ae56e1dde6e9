"""EigenKernel on PyTorch and CUDA: the port of ``eigenkernel_tpu``."""

from eigenkernel_tpu_torch.version import VERSION

__version__ = VERSION
