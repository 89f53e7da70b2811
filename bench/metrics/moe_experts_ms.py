"""Device ms a batch of the MoE blocks' experts: the dispatch einsum, the
three expert matmuls, the combine einsum (the program's ``moe.experts``
phase, summed over the layers), outside the profiled slice."""
from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "moe.experts")
