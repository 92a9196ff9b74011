"""Command-line entry points of the port (``gist_tpu/cli``), each a
``main(argv=None)`` that runs as ``python -m gist_tpu_torch.cli.<name>``
and returns its result dict.  They run on the card unless given
``--device cpu``."""
