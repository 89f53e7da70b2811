"""Device ms a batch of the MoE blocks' shared experts: their one SwiGLU
over every token (the program's ``moe.shared`` phase, summed over the
layers), outside the profiled slice; None where the program has no such
phase."""
from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "moe.shared")
