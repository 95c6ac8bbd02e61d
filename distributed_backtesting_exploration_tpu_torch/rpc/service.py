"""gRPC service and client stubs for the Dispatcher contract (the
reference's ``rpc/service.py``).

Hand-written equivalent of what ``grpc_tools.protoc``'s python-grpc plugin
would generate from ``backtesting.proto``: :class:`DispatcherServicer` and
:func:`add_dispatcher_to_server` on the dispatcher's side,
:class:`DispatcherStub` on the worker's, and the channel options (gzip both
ways, message sizes for OHLCV blocks). The method names and message classes
mirror the service block of ``backtesting.proto``, so a JAX worker and a
PyTorch worker serve a dispatcher of either package.

Distributed-trace propagation rides in the messages (``JobSpec.trace_id``
/ ``parent_span_id``, ``CompleteItem.trace_id``), not in gRPC metadata.
"""

from __future__ import annotations

import grpc

from . import backtesting_pb2 as pb

SERVICE_NAME = "dbx.rpc.Dispatcher"

# (method, request class, reply class) — mirrors the service block in
# backtesting.proto.
_METHODS = (
    ("RequestJobs", pb.JobsRequest, pb.JobsReply),
    ("SendStatus", pb.StatusRequest, pb.Ack),
    ("CompleteJob", pb.CompleteRequest, pb.Ack),
    ("CompleteJobs", pb.CompleteBatch, pb.CompleteBatchReply),
    ("GetStats", pb.StatsRequest, pb.StatsReply),
    ("FetchPayload", pb.PayloadRequest, pb.PayloadReply),
    ("AppendBars", pb.AppendRequest, pb.AppendReply),
    ("FetchCompiled", pb.CompiledRequest, pb.CompiledReply),
    ("OfferCompiled", pb.CompiledOffer, pb.Ack),
    ("TriggerDump", pb.DumpRequest, pb.DumpReply),
)

# Server-streaming RPCs (the live signal fan-out's Subscribe): the
# handler is a GENERATOR that yields replies for the stream's lifetime,
# so it occupies one server thread-pool slot per live subscriber
# connection — size DispatcherServer(max_workers=...) for the expected
# connection count plus unary headroom (one connection can carry many
# interests; see SubscribeRequest).
_STREAM_METHODS = (
    ("Subscribe", pb.SubscribeRequest, pb.PushUpdate),
)


class DispatcherServicer:
    """Interface for the server side; subclass and override each RPC."""

    def RequestJobs(self, request: pb.JobsRequest, context) -> pb.JobsReply:
        raise NotImplementedError

    def SendStatus(self, request: pb.StatusRequest, context) -> pb.Ack:
        raise NotImplementedError

    def CompleteJob(self, request: pb.CompleteRequest, context) -> pb.Ack:
        raise NotImplementedError

    def CompleteJobs(self, request: pb.CompleteBatch,
                     context) -> pb.CompleteBatchReply:
        raise NotImplementedError

    def GetStats(self, request: pb.StatsRequest, context) -> pb.StatsReply:
        raise NotImplementedError

    def FetchPayload(self, request: pb.PayloadRequest,
                     context) -> pb.PayloadReply:
        raise NotImplementedError

    def AppendBars(self, request: pb.AppendRequest,
                   context) -> pb.AppendReply:
        raise NotImplementedError

    def FetchCompiled(self, request: pb.CompiledRequest,
                      context) -> pb.CompiledReply:
        raise NotImplementedError

    def OfferCompiled(self, request: pb.CompiledOffer,
                      context) -> pb.Ack:
        raise NotImplementedError

    def Subscribe(self, request: pb.SubscribeRequest, context):
        """Server-streaming: yields :class:`pb.PushUpdate` messages."""
        raise NotImplementedError


def add_dispatcher_to_server(servicer: DispatcherServicer, server) -> None:
    """Register the servicer's unary + server-streaming handlers."""
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=rep.SerializeToString,
        )
        for name, req, rep in _METHODS
    }
    handlers.update({
        name: grpc.unary_stream_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=rep.SerializeToString,
        )
        for name, req, rep in _STREAM_METHODS
    })
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))


class DispatcherStub:
    """Client stub; one callable per RPC, bound to ``channel``.

    Streaming stubs (``Subscribe``) return an iterator of replies; the
    call stays open until the client drops it (``.cancel()`` / channel
    close) or the server ends the stream."""

    def __init__(self, channel: grpc.Channel):
        for name, req, rep in _METHODS:
            setattr(self, name, channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=rep.FromString,
            ))
        for name, req, rep in _STREAM_METHODS:
            setattr(self, name, channel.unary_stream(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=rep.FromString,
            ))


def default_channel_options() -> list[tuple[str, object]]:
    """Channel/server options: gzip + generous message sizes for OHLCV blocks."""
    return [
        ("grpc.default_compression_algorithm", grpc.Compression.Gzip),
        ("grpc.max_send_message_length", 256 * 1024 * 1024),
        ("grpc.max_receive_message_length", 256 * 1024 * 1024),
    ]
