"""Timing, tracing and the roofline of the port's kernels on the card."""
