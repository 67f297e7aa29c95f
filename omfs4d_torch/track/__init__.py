"""FLAME tracking: landmark sources, preflight gates and the staged fitter."""
