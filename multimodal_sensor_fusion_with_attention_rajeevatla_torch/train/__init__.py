"""Training runtime of the port (optimizer, augmentations, the train step)."""
