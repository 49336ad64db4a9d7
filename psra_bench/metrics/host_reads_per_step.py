"""Host waits on the device a step: the CUDA runtime calls in the trace
that block the host until the device is done (stream, device and event
synchronizations, synchronous copies). A ``.item()`` or a copy to the
host inside the step counts once; the loop's own wait for a finished
batch counts once a step. The tracer's own syncs around the traced steps
are not counted."""


def read(view, split):
    if not view.runtime or not view.steps:
        return None
    return view.host_reads() / view.steps
