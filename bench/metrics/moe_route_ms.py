"""Device ms a batch of the MoE blocks' routing: router logits, top-k,
dispatch and combine tensors (the program's ``moe.route`` phase, summed
over the layers), outside the profiled slice."""
from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "moe.route")
