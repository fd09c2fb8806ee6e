"""Command-line entry points.  Ports ``repro/launch``'s ``serve``; the training
and dry-run entry points come in later slices (see ROADMAP.md)."""
