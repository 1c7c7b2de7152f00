"""One module an entry of the program that a traffic mix can drive; each
has a ``Run`` class (``setup``, ``window``, ``end_to_end``, ``check``)."""
