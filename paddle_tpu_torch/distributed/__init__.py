"""Distributed training and serving.  So far only the atomic,
integrity-checked version directories of ``checkpoint`` (the prefix
cache's export uses them)."""
