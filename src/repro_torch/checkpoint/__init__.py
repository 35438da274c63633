"""Checkpoints: atomic, asynchronous, resumable (``store``)."""
