"""``train_nodes_per_s``: the real (unpadded) batch nodes of every
sub-model step of the window's rounds, over the window's wall seconds
(host clock; the window closes on a device synchronisation)."""


def read(rec):
    return rec.nodes() / rec.window_s
