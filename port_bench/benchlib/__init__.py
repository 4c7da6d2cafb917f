"""The benchmark's own library: discovery, traffic, weights, tracing, readers,
comparison and the run itself."""
