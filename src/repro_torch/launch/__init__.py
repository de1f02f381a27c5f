"""Launch: step builders and the training driver."""
