"""Errors shared across the port."""


class NotYetPorted(Exception):
    """An input, option or document feature whose code path is not yet
    ported to paintfe_tpu_torch."""
