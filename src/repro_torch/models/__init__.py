"""Models of the port: parameter trees, layers, paged attention and the
dense decoder (``registry.build_model`` is the entry point)."""
