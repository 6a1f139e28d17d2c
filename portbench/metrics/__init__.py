"""Per-layer metric readers: one module a metric, named as the metric in
``BENCHMARK.json``, each with ``read(ctx)`` returning the value or None
where its source holds nothing to read (``run.py`` leaves the metric out
of the result then).  ``ctx`` is the dict ``run.py`` builds after the
window: ``trace`` (``devtrace.Trace`` of the traced sub-window),
``cfg`` (the configuration), ``peaks`` (the card's row of
``flops.PEAKS`` or None), ``images_per_s`` (the window's rate, as the
end-to-end metric reads it), ``batch_ms`` (the latency of every window
batch that came back before the profiler started),
``tiles_used`` (every window result's tiles a row) and
``batches_traced`` (results that came back inside the traced
sub-window)."""
