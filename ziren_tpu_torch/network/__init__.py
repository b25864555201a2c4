"""Remote proving backends (reference L9).

The reference offloads proving two ways: a twirp/protobuf `ProverService`
to a GPU prover container (crates/cuda/proto/api.proto — Ready, Setup,
ProveCore, Compress, Shrink, Wrap with bincode payloads) and a gRPC proof
network (crates/sdk/src/network/prover.rs). This package is the TPU-era
analogue: the prover is in-process on the accelerator host, and remote
callers reach it over the same-shape RPC surface —

  * `service.ProverServer` — threaded HTTP server exposing
    POST /twirp/ProverService/{Ready,Setup,ExecuteProgram,ProveCore,
    CompressedProve,Verify} with binary-pickled payloads (the bincode
    analogue; trusted-network protocol, exactly like the reference's
    Docker-local twirp channel).
  * `client.NetworkProver` — a ProverClient-shaped facade that proxies
    every stage to a remote server and verifies results locally.
"""

from .client import NetworkProver
from .service import ProverServer

__all__ = ["NetworkProver", "ProverServer"]
