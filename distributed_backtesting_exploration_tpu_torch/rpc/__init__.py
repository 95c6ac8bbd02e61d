"""The dispatcher <-> worker gRPC contract, both sides.

``backtesting.proto`` and ``backtesting_pb2`` are byte-identical copies of
the reference's, so JAX and PyTorch workers serve one fleet. :mod:`.wire`
holds the result codecs (DBXM, DBXS, DBXP), :mod:`.panel_store` the panel
digest, its byte-bounded LRU and the dispatcher's panel store, :mod:`.compute` the two-phase sweep
backend with its panel cache, :mod:`.executor` the worker's compute side
(a serial loop, or the submit/collect pipeline), :mod:`.journal` the
crash-durable job journal, :mod:`.aggregate` the read path of stored
results, :mod:`.service` the server and client stubs, :mod:`.dispatcher`
the leased queue and its server, and :mod:`.worker` the polling loop.
The last three import ``grpc``, so only :mod:`.aggregate` is imported
here.

Run a dispatcher and a worker against it:

    python -m distributed_backtesting_exploration_tpu_torch.rpc.dispatcher \
        --synthetic 64 --journal q.jsonl --results-dir results
    python -m distributed_backtesting_exploration_tpu_torch.rpc.worker \
        --connect localhost:50051 --device cuda

Read a fleet's stored results:

    python -m distributed_backtesting_exploration_tpu_torch.rpc.aggregate \
        --results-dir DIR --journal PATH
"""

from . import aggregate  # noqa: F401
