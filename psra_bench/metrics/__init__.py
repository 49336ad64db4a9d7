"""Per-layer metric readers, one module a metric (named by the part of
the metric's name before its first dot). Each has ``read(view, split)``:
``view`` is a :class:`psra_bench.trace.TraceView` of the traced steps and
``split`` the rest of the metric's name (the study it is reported for).
A reader returns None where the trace holds nothing for it, never 0 for
a share of a roofline."""
