"""Runtime: fault injection (chaos registry, watchdog) and the training
supervisor."""
