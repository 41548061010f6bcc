"""Models built on the transpose convolution: the Table-4 GAN generators."""
