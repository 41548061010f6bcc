"""The training path: checkpoints and the fault-tolerant GAN trainer."""
