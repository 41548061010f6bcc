"""Launch entry points. Mirrors ``repro/launch``: :mod:`.train` (an arch
through the Trainer, under the host or a production mesh), :mod:`.mesh`
(the meshes) and :mod:`.roofline` (the card's peaks and the three-term
roofline). The reference's ``dryrun``, ``hlo_analysis`` and ``attribution``
lower and compile JAX programs over 256- and 512-chip TPU meshes and read
XLA's HLO (its FLOP counts, its collectives); a PyTorch program has no
compiled HLO module, so they have no counterpart here."""
