"""Drivers of the benchmark's traffic: ``train`` (closed-loop train steps)
and ``serve`` (closed-loop full scenes). A traffic file names its driver."""
