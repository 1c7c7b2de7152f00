"""The benchmark's own input generators: images and coefficients made
from the seed, and JPEG streams for the decode cells."""
