"""The port's runnable examples and the training loop they share."""
