"""K2a's share (%) of its roofline over the traced steps, on the blocked
LP route's panels (``kernels/k2.py``)."""
from psra_bench.kernels import k2
from psra_bench.metrics import _roofline


def read(view, split):
    return _roofline.share(view, "k2", k2.KERNEL_NAMES)
