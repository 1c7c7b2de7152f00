"""Streaming decode pipeline."""
