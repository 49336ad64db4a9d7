"""Kernels' operations and bytes, counted from what each call is handed.

One module a kernel, ``k<N>.py``, with ``install(tracer)`` (wraps the
kernel's Python entry to record each call's shapes while the tracer
records; returns what to restore), ``count(calls)`` (finishes each
record's ``flops`` and ``bytes`` after the traced window) and
``KERNEL_NAMES`` (substrings of the kernel's names in a trace). The
bound of a call is max(operations / peak FLOP/s, bytes / peak bytes/s)
with the peaks of :mod:`psra_bench.kernels.peaks`; each input is read
once and each output written once, a symmetric or triangular matrix as
its lower triangle.
"""
