"""The port's tools: the measurement tools ``roofline`` (the card's ceilings
against the production step's modeled floor), ``microbench`` (gather
variants and pass-1 tile widths) and ``launch_cost``; the long-horizon
validation tools ``drift100k`` (the drift protocol and its ship gate),
``rotating_l_check``, ``equilibrium_run`` and ``drift_probe``; the halo
layout's tools ``settle_ball``, ``halo_collision`` (the two-planet
collision on 8 ranks) and ``halo_debug``; and the developer tools
``profile_build``, ``scaling_bench``, ``neighbors_of``, ``span_stats``,
``ksweep``, ``ksweep2`` and ``micro_gather``; and the trace and stage
tools ``profile_block`` (the stages of the block pipeline), ``trace_run``
(a traced production chunk) and ``trace_summary`` (a Chrome trace's device
ops by self time, by category, and the idle share)."""
