"""Fault injection (``chaos``) and the block ledger sanitizer
(``blocksan``) of the serving engine's crash-only tests."""
