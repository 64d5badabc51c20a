"""Runtime I/O: PSPH1 snapshots through the native C++ writer (built with
g++ at first use) or, without a compiler, the same bytes in numpy."""
