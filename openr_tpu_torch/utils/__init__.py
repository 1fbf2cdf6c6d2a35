"""Topology generators for tests and the chip smoke run."""
