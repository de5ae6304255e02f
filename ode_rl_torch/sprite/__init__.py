"""The Sprites DS-VAE: its data, DCGAN frame nets and model."""
