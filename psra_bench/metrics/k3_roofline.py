"""K3's share (%) of its roofline over the traced steps: its
``trsm_fwd`` / ``trsm_bwd`` calls on the blocked LP route
(``kernels/k3.py``)."""
from psra_bench.kernels import k3
from psra_bench.metrics import _roofline


def read(view, split):
    return _roofline.share(view, "k3", k3.KERNEL_NAMES)
