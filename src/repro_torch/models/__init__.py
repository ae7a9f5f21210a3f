"""Model stack of the port: config, registry, layers, attention, lm."""
