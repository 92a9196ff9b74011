"""``ist_sync_ms``: host milliseconds a round of the IST dispatch and
merge: the harness's ``dispatch`` and ``merge`` spans (boundary draws,
slicing, the sub-parameters to the card, the trained shards back,
stacking, merge) inside the window, over its rounds.  In the traced run
each span opens and closes on a device synchronisation, so the bursts'
device tail does not count in them."""


def read(rec):
    return 1e3 * rec.span_s("dispatch", "merge") / len(rec.rounds)
