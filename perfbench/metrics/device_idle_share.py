"""``device_idle_share``: the share of the traced window in which no
device operation ran (1 - the union of the operations' intervals over
the window), in %."""


def read(rec):
    busy = rec.busy_s()
    return None if busy is None else 100.0 * (1.0 - busy / rec.traced_s())
