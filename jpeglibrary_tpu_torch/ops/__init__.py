"""Device ops of the PyTorch port: the decode and encode stages, colour,
the wire pipeline, the device entropy decode, and the kernels K1, K2 and
K3 with their wrappers (``kernels``)."""
