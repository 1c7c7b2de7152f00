"""The general part of the harness: the spec, the run, spans and traces,
and the table of peaks."""
