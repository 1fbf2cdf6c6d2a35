"""Device engine: resolved device, staged arrays, dispatch accounting."""
