"""Tools of the port (``tools/``): run as ``python -m monorec_tpu_torch.tools.<name>``."""
