"""Atomic version directories (``manager``) and transient-I/O retries
(``io_retry``)."""
