"""Worker side of the dispatcher <-> worker gRPC contract.

``backtesting.proto`` and ``backtesting_pb2`` are byte-identical copies of
the reference's, so JAX and PyTorch workers serve one fleet. :mod:`.wire`
holds the result codecs (DBXM, DBXS, DBXP), :mod:`.panel_store` the panel
digest and its byte-bounded LRU, :mod:`.compute` the two-phase sweep
backend with its panel cache, :mod:`.executor` the worker's compute side
(a serial loop, or the submit/collect pipeline), :mod:`.journal` the
journal's reader, :mod:`.aggregate` the read path of stored results,
:mod:`.service` the client stub and :mod:`.worker` the polling loop. Only
the last two import ``grpc``, so only :mod:`.aggregate` is imported here.

Run a worker against a dispatcher:

    python -m distributed_backtesting_exploration_tpu_torch.rpc.worker \
        --connect localhost:50051 --device cuda

Read a fleet's stored results:

    python -m distributed_backtesting_exploration_tpu_torch.rpc.aggregate \
        --results-dir DIR --journal PATH
"""

from . import aggregate  # noqa: F401
