"""Seeded violation for ``lock-blocking`` with the card's wait: a CUDA
event's ``synchronize`` under an index lock (the PagePool scrape-stall
class), so every stats scrape stalls for the transfer. Never imported;
the rule works on the AST alone."""

import threading

import torch


class StallingPool:
    def __init__(self):
        self._lock = threading.Lock()
        self._pages = {}

    def upload(self, key, page):
        done = torch.cuda.Event()
        with self._lock:
            self._pages[key] = page.to("cuda", non_blocking=True)
            done.record()
            # VIOLATION (lock-blocking): the card's wait under the lock.
            done.synchronize()

    def upload_stream(self, key, page, stream):
        with self._lock:
            self._pages[key] = page.to("cuda", non_blocking=True)
            # dbxlint: disable=lock-blocking -- suppressed twin of the above
            stream.synchronize()

    def scrape(self):
        with self._lock:
            return len(self._pages)
