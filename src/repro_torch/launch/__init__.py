"""Command-line entry points, the step functions, the mesh and the dry
run.  Ports ``repro/launch``'s ``serve``, ``worker``, ``train``,
``steps``, ``mesh``, ``roofline_math``, ``dryrun`` and ``hlo_analysis``
(the last two over one rank's dispatched ops on a fake process group, not
over compiled HLO)."""
