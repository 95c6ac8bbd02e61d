"""gRPC client stub for the Dispatcher contract (reference ``rpc/service.py``).

The worker side only: one callable per unary RPC, bound to a channel, and
the channel options (gzip both ways, message sizes for OHLCV blocks). The
method names and message classes mirror the service block of
``backtesting.proto``.
"""

from __future__ import annotations

import grpc

from . import backtesting_pb2 as pb

SERVICE_NAME = "dbx.rpc.Dispatcher"

# (method, request class, reply class) of the RPCs the worker calls.
_METHODS = (
    ("RequestJobs", pb.JobsRequest, pb.JobsReply),
    ("SendStatus", pb.StatusRequest, pb.Ack),
    ("CompleteJobs", pb.CompleteBatch, pb.CompleteBatchReply),
    ("FetchPayload", pb.PayloadRequest, pb.PayloadReply),
)


class DispatcherStub:
    """Client stub; one callable per RPC, bound to ``channel``."""

    def __init__(self, channel: grpc.Channel):
        for name, req, rep in _METHODS:
            setattr(self, name, channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=rep.FromString,
            ))


def default_channel_options() -> list[tuple[str, object]]:
    """Channel options: gzip + generous message sizes for OHLCV blocks."""
    return [
        ("grpc.default_compression_algorithm", grpc.Compression.Gzip),
        ("grpc.max_send_message_length", 256 * 1024 * 1024),
        ("grpc.max_receive_message_length", 256 * 1024 * 1024),
    ]
