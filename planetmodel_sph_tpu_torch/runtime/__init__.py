"""Runtime I/O: the PSPH1 snapshot format in pure numpy."""
