"""Image ops: interpolation, pyramid, sparse-direct and patch alignment."""
