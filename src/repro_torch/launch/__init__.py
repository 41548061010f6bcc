"""Launch entry points. Mirrors ``repro/launch``: only :mod:`.train` is ported;
the dry-run, HLO, mesh, attribution and roofline tools lower JAX programs
over TPU meshes (ROADMAP queue 1, "launch/*")."""
