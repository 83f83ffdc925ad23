"""Command-line tools of the port: the serving export and the checkpoint and
data converters (host jobs, run on the CPU), and the probes that run on the
card."""
