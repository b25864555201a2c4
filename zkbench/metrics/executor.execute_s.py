"""executor.execute_s: host seconds a request spends in the executor
(ziren_tpu_torch/executor/executor.py: Executor.run_sharded, which
ProverClient.prove calls with a shard size), per completed request."""

UNIT = "s/request"
LAYER = "executor"
MOVES = "prove_khz"
WRAPS = [("executor", "ziren_tpu_torch.executor.executor:Executor.run_sharded")]


def read(run):
    if run.spans is None or not run.done or not run.spans.of("executor"):
        return None
    return run.spans.seconds("executor") / len(run.done)
