"""Device entry points of decoded results."""
