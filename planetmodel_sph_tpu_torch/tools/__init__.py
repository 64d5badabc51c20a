"""The port's measurement tools: ``roofline`` (the card's ceilings against
the production step's modeled floor) and ``microbench`` (gather variants
and pass-1 tile widths)."""
