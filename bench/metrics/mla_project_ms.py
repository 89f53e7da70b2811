"""Device ms a batch of the MLA blocks' projections: q, kv_a, the latent
norm, kv_b, RoPE and the concatenation into 192-wide q and k (the
program's ``mla.project`` phase, summed over the layers), outside the
profiled slice; None where the program has no such phase."""
from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "mla.project")
