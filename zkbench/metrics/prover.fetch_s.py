"""prover.fetch_s: host seconds a request waits in the shard prover's fetch,
the one device-to-host copy after the last dispatch, which waits for the
card to finish the shards' work (StarkMachine.prove's `stats=` fetch_s),
per completed request."""

UNIT = "s/request"
LAYER = "shard prover"
MOVES = "prove_khz"
WRAPS = [("prove", "ziren_tpu_torch.stark.machine:StarkMachine.prove")]


def read(run):
    if run.spans is None or not run.done or not run.spans.stats:
        return None
    fetched = [st["fetch_s"] for st in run.spans.stats if "fetch_s" in st]
    if not fetched:
        return None
    return sum(fetched) / len(run.done)
