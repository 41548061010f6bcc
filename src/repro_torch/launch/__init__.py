"""Launch entry points. Mirrors ``repro/launch``: :mod:`.train` (an arch
through the Trainer, its state placed over the host or a production mesh),
:mod:`.mesh` (the meshes, and the production mesh's shape over a fake
process group), :mod:`.roofline` (the card's peaks and the three-term
roofline), :mod:`.dryrun` (every cell placed and traced on a fake 256- or
512-rank world in one process), :mod:`.attribution` (its collectives
ranked by wire bytes) and :mod:`.op_analysis`, which takes the place of
the reference's ``hlo_analysis``: a PyTorch program has no HLO to parse,
so the counts are taken from the traced call's dispatched ops."""
