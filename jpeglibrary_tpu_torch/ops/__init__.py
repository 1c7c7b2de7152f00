"""Device ops of the PyTorch port: decode stage, colour, K1 and the v2 pipeline."""
