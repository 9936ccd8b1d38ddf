"""npz manifest checkpoints and the reference-to-port weight bridge."""
