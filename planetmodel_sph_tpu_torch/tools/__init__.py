"""The port's tools: the measurement tools ``roofline`` (the card's ceilings
against the production step's modeled floor), ``microbench`` (gather
variants and pass-1 tile widths) and ``launch_cost``, and the long-horizon
validation tools ``drift100k`` (the drift protocol and its ship gate),
``rotating_l_check``, ``equilibrium_run`` and ``drift_probe``."""
