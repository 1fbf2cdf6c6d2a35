"""Relax ops and the fused epilogue kernel of the fleet product."""
