"""``setup_s``: seconds from the process's start to the window's (the
cached graph loaded, the program's sampler built, the tables moved to
the card, the kernels loaded and the warm-up rounds run)."""


def read(rec):
    return rec.setup_s
