"""Worker side of the dispatcher <-> worker gRPC contract.

``backtesting.proto`` and ``backtesting_pb2`` are byte-identical copies of
the reference's, so JAX and PyTorch workers serve one fleet. :mod:`.wire`
is the DBXM result codec, :mod:`.compute` the sweep backend, :mod:`.service`
the client stub and :mod:`.worker` the polling loop. Only the last two
import ``grpc``, so nothing is imported here eagerly.

Run a worker against a dispatcher:

    python -m distributed_backtesting_exploration_tpu_torch.rpc.worker \
        --connect localhost:50051 --device cuda
"""
