"""Device-parallel rungs of the fleet product (blocked APSP on one device)."""
