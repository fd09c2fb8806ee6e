"""Command-line entry points, the step functions and the mesh.  Ports
``repro/launch``'s ``serve``, ``worker``, ``train``, ``steps``, ``mesh``
and ``roofline_math``; the TPU dry-run tools (``dryrun.py``,
``hlo_analysis.py``) come in a later slice (see ROADMAP.md)."""
