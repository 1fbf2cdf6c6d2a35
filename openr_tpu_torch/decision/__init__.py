"""Route computation: link state, CSR mirror, fleet product, SpfSolver."""
