"""The plain reference of the benchmark: the notebook's VAE-GAN, its training
step and its evaluation-mode reconstruction in plain PyTorch float32, with the
draws of the system under test worked out again from the seeds. It imports
torch and numpy only: nothing of the system under test and nothing of JAX."""
