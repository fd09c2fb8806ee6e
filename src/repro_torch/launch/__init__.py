"""Command-line entry points and the step functions.  Ports
``repro/launch``'s ``serve``, ``worker``, ``train`` and ``steps``; the
mesh (``launch/mesh.py``) and the TPU dry-run tools (``dryrun.py``,
``hlo_analysis.py``, ``roofline_math.py``) come in later slices (see
ROADMAP.md)."""
