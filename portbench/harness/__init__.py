"""The harness: set-up, window, check and metrics of one cell."""
