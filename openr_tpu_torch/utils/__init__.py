"""Topology generators for tests and the chip smoke run, and the
exponential backoff Fib retries with."""
