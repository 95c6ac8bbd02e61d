"""Seeded violation for ``blocking-call`` with the card's wait: a servicer
handler that synchronizes the card (``torch.cuda.synchronize``), which
stalls the shared gRPC thread pool for as long as the card takes to
drain. Never imported; the rule works on the AST alone."""

import torch


class DispatcherServicer:
    """Stand-in for the generated base class."""


class SyncingDispatcher(DispatcherServicer):
    def GetStats(self, request, context):
        # VIOLATION (device-sync vocabulary): the handler waits for the card.
        torch.cuda.synchronize()
        return None

    def SendStatus(self, request, context):
        # dbxlint: disable=blocking-call -- suppressed twin of the above
        torch.cuda.current_stream().synchronize()
        return None
