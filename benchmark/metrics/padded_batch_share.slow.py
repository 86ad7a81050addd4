"""padded_batch_share.slow: The program's dp_batches_padded over
dp_batches_padded + dp_batches_compact (phase A batches by the DP route
taken), %.  None where neither counter moved."""


def read(run):
    padded = run.total("dp_batches_padded")
    n = padded + run.total("dp_batches_compact")
    return 100.0 * padded / n if n else None
