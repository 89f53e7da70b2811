"""Training: the optimizers, NE and the train loop."""
