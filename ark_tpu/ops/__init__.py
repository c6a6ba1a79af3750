"""Device compute kernels (jitted XLA programs) for the framework's hot ops."""
