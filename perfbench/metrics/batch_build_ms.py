"""``batch_build_ms``: host milliseconds of the batch build a batch: the
harness's ``batch_build`` spans (``_RoundCollector.collect`` and
``_batches_to_device``, in the worker thread where the round collects
there) inside the window, over the batches the window's rounds
trained."""


def read(rec):
    n = sum(len(r) for r in rec.rounds)
    return 1e3 * rec.span_s("batch_build") / n if n else None
