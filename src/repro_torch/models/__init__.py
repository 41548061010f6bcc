"""Models: the Table-4 GAN generators built on the transpose convolution,
and the dense decoder LM."""
